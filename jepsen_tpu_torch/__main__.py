"""Default CLI entry: the demo suite plus serve/analyze
(reference cli.clj -main, extended with the demo workload registry; the
port's copy of ``jepsen_tpu/__main__.py``).

    python -m jepsen_tpu_torch test --workload register --no-ssh
    python -m jepsen_tpu_torch test --workload register --no-ssh --device cpu
    python -m jepsen_tpu_torch test-all --no-ssh

    python -m jepsen_tpu_torch campaign --no-ssh --axis workload=register \
        --seeds 2 --parallel 2

    python -m jepsen_tpu_torch serve --host 127.0.0.1 --token T

``serve`` runs the store viewer and the submission API (``/api/check``)
on the card (``--device cpu`` for the plain PyTorch path).
"""

from __future__ import annotations

from . import cli, demo


def _add_demo_opts(parser):
    parser.add_argument("--workload", default="register",
                        choices=sorted(demo.WORKLOADS),
                        help="Which demo workload to run.")
    parser.add_argument("--bug", default=None,
                        choices=["lost-write", "dirty-read",
                                 "stale-read", "future-read"],
                        help="Inject a bug into the demo client so "
                             "checkers catch it (future-read / "
                             "stale-read target the txn workloads).")
    parser.add_argument("--nemesis", default=None,
                        choices=["none", "faketime", "charybdefs"],
                        help="Nemesis axis for the txn workloads "
                             "(faketime skews node clocks; charybdefs "
                             "degrades the filesystem).")
    parser.add_argument("--algorithm", default="jax-wgl",
                        help="Linearizability engine (wgl, jax-wgl, "
                             "competition).")
    parser.add_argument("--per-key-limit", type=int, default=20,
                        help="Ops per key for keyed workloads.")


def _tests_fn(options):
    tests = []
    for name in sorted(demo.WORKLOADS):
        opts = dict(options)
        opts["workload"] = name
        tests.append(demo.demo_test(opts))
    return tests


def main(argv=None):
    subcommands = {}
    subcommands.update(cli.single_test_cmd({
        "test-fn": demo.demo_test,
        "opt-spec": _add_demo_opts,
    }))
    subcommands.update(cli.test_all_cmd({
        "tests-fn": _tests_fn,
        "opt-spec": _add_demo_opts,
    }))
    subcommands.update(cli.campaign_cmd({
        "test-fn": demo.demo_test,
        "opt-spec": _add_demo_opts,
        # fleet workers rebuild cells in their own process from this
        # importable ref (must match test-fn)
        "builder": "jepsen_tpu_torch.demo:demo_test",
    }))
    subcommands.update(cli.serve_cmd())
    cli.run(subcommands, argv)


if __name__ == "__main__":
    cli.hard_main(main)
