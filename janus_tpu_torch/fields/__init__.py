"""Finite fields for Prio3: host ints (`field`) and batched tensors (`tfield`)."""

from .field import Field64, Field128  # noqa: F401
from .tfield import TF64, TF128  # noqa: F401
