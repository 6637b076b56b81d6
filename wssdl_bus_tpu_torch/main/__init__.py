"""The port's command-line entry points (counterpart of
``wssdl_bus_tpu/main``): ``python -m wssdl_bus_tpu_torch.main.test``,
``main.train``, ``main.train_alter``, ``main.export`` and ``main.predict``
(the HTTP server is ``python -m wssdl_bus_tpu_torch.serve.server``)."""
