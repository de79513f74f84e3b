"""The LM testbed's model zoo (the reference's ``repro.models``): configs in
:mod:`repro_torch.configs`, blocks and the stack here, ``build`` the entry."""
from repro_torch.models.api import ModelBundle, build

__all__ = ["ModelBundle", "build"]
