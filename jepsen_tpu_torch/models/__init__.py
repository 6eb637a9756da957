"""Consistency models: knossos.model equivalents with both Python oracle and
tensor faces (see base.py). The register family and the mutex are ported;
the queue models come with a later slice of the port and raise KeyError
here."""

from .base import (Inconsistent, Interner, Model, ModelSpec, inconsistent,
                   is_inconsistent, known_models, model_spec, not_ported,
                   register_model)
from .mutex import Mutex, mutex_spec
from .registers import (CASRegister, MultiRegister, Register,
                        cas_register_spec, multi_register_spec, register_spec)


# knossos.model constructor-style aliases
def register(value=None):
    return Register(value)


def cas_register(value=None):
    return CASRegister(value)


def mutex():
    return Mutex()


def multi_register(values=None):
    return MultiRegister(values)


def fifo_queue(*items):
    raise not_ported("fifo-queue")


def unordered_queue(*items):
    raise not_ported("unordered-queue")


__all__ = [
    "Inconsistent", "Interner", "Model", "ModelSpec", "inconsistent",
    "is_inconsistent", "known_models", "model_spec", "register_model",
    "CASRegister", "MultiRegister", "Register", "Mutex", "register_spec",
    "cas_register_spec", "multi_register_spec", "mutex_spec", "register",
    "cas_register", "mutex", "multi_register", "fifo_queue",
    "unordered_queue",
]
