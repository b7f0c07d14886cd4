"""Distribution tools of the port: ``build_dist`` (the wheel and
``amr-torch.pyz``) and ``build_standalone`` (``amr-torch.run``)."""
