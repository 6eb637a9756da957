"""Operating system setup and teardown (reference
jepsen/src/jepsen/os.clj).

Implementations: `jepsen_tpu_torch.os.debian`, `.centos`, `.ubuntu`,
`.smartos` — each exposes a module-level ``os`` instance plus its package
helpers (install, installed, maybe_update, ...).
"""

from __future__ import annotations


class OS:
    """Per-node OS prep/teardown (os.clj:4-8)."""

    def setup(self, test, node):
        """Set up the operating system on this particular node."""

    def teardown(self, test, node):
        """Tear down the operating system on this particular node."""


class _Noop(OS):
    """Does nothing (os.clj:10-14)."""


noop = _Noop()
