"""The H100 benchmark of the detector's PyTorch/CUDA port: the kinds of
traffic it drives, the plain reference its outputs are held against, the
synthetic database, the work counts and the trace reduction."""
