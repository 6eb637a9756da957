"""Client protocol: applies operations to a database (reference
jepsen/src/jepsen/client.clj).

A client is opened per (node, process): ``open`` makes a connection without
touching logical state, ``setup``/``teardown`` manage database state,
``invoke`` applies one op and returns its completion. Crashed clients are
closed and reopened for the successor process unless ``reusable`` says
otherwise (client.clj:29-44)."""

from __future__ import annotations


class Client:
    """Lifecycle: open -> setup -> invoke* -> teardown -> close
    (client.clj:9-27)."""

    def open(self, test, node):
        """Connect to node; returns a ready client. Must not affect logical
        state."""
        return self

    def close(self, test):
        """Release the connection. Must not affect logical state."""

    def setup(self, test):
        """Set up database state for testing."""

    def invoke(self, test, op):
        """Apply op; return the completed op (type ok/fail/info)."""
        raise NotImplementedError

    def teardown(self, test):
        """Tear down database state."""

    def reusable(self, test):
        """May a crashed client be reused by the successor process?
        (client.clj Reusable, :29-44)"""
        return False


class _Noop(Client):
    """Does nothing (client.clj:46-53)."""

    def invoke(self, test, op):
        out = dict(op)
        out["type"] = "ok"
        return out


noop = _Noop()


class InvalidCompletion(Exception):
    pass


class Validate(Client):
    """Asserts completions are well-formed: a dict with type ok/info/fail
    and unchanged process/f (client.clj:64-109)."""

    def __init__(self, client):
        self.client = client

    def open(self, test, node):
        res = self.client.open(test, node)
        if not isinstance(res, Client):
            raise InvalidCompletion(
                f"expected open to return a Client, got {res!r}")
        return Validate(res)

    def close(self, test):
        self.client.close(test)

    def setup(self, test):
        self.client.setup(test)
        return self

    def invoke(self, test, op):
        out = self.client.invoke(test, op)
        problems = []
        if not isinstance(out, dict):
            problems.append("should be a dict")
        else:
            if out.get("type") not in ("ok", "info", "fail"):
                problems.append("type should be ok, info, or fail")
            if out.get("process") != op.get("process"):
                problems.append("process should be the same")
            if out.get("f") != op.get("f"):
                problems.append("f should be the same")
        if problems:
            raise InvalidCompletion(
                f"invalid completion {out!r} for {op!r}: "
                + "; ".join(problems))
        return out

    def teardown(self, test):
        self.client.teardown(test)

    def reusable(self, test):
        return self.client.reusable(test)


def validate(client):
    return Validate(client)


class FnClient(Client):
    """Build a client from a single invoke function (handy in tests)."""

    def __init__(self, fn):
        self.fn = fn

    def invoke(self, test, op):
        return self.fn(test, op)
