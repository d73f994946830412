"""Deprecated shim: ``repro_torch.launch.serve`` is
:mod:`repro_torch.launch.generate` ("serve" now means the plan server,
``python -m repro_torch.service``)."""
from .generate import main  # noqa: F401

if __name__ == "__main__":
    raise SystemExit(main())
