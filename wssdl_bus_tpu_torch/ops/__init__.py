"""Detection geometry and the two kernels of the serving path.

Each kernel wrapper (``nms_cuda.nms_keep``, ``roi_pool_cuda.roi_pool_fc``)
launches its CUDA kernel on CUDA tensors and takes the plain PyTorch version
beside it (``nms.nms_mask``, ``roi_pool.roi_pool``) on CPU tensors."""
