"""Consistency models: knossos.model equivalents with both Python oracle and
tensor faces (see base.py): the register family, the mutex and the two
queue models, as in ``jepsen_tpu.models``."""

from .base import (Inconsistent, Interner, Model, ModelSpec, inconsistent,
                   is_inconsistent, known_models, model_spec, register_model)
from .mutex import Mutex, mutex_spec
from .queues import (FIFOQueue, UnorderedQueue, fifo_queue_spec,
                     unordered_queue_spec)
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
    return FIFOQueue(items)


def unordered_queue(*items):
    return UnorderedQueue(items)


__all__ = [
    "Inconsistent", "Interner", "Model", "ModelSpec", "inconsistent",
    "is_inconsistent", "known_models", "model_spec", "register_model",
    "CASRegister", "MultiRegister", "Register", "Mutex", "FIFOQueue",
    "UnorderedQueue", "register_spec", "cas_register_spec",
    "multi_register_spec", "mutex_spec", "fifo_queue_spec",
    "unordered_queue_spec", "register",
    "cas_register", "mutex", "multi_register", "fifo_queue",
    "unordered_queue",
]
