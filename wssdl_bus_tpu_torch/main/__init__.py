"""The port's command-line entry points (counterpart of
``wssdl_bus_tpu/main``): ``python -m wssdl_bus_tpu_torch.main.test``."""
