"""Detection geometry, training targets and the kernels.

Each kernel wrapper (``nms_cuda.nms_keep``, ``roi_pool_cuda.roi_pool_fc``
and its backward ``roi_pool_cuda.roi_pool_fc_backward``) launches its CUDA
kernel on CUDA tensors and takes the plain PyTorch version beside it
(``nms.nms_mask``, ``roi_pool.roi_pool`` / ``roi_pool.roi_pool_grad``) on
CPU tensors."""
