"""Exemplar consumer suites: complete, runnable tests for real systems,
built on the framework the way the reference's per-database projects are
(SURVEY.md §2.8 — e.g. zookeeper.clj as the minimal single-file example,
tidb/core.clj for the workload-registry pattern). The port's copy of
``jepsen_tpu/suites``: the etcd and txn suites; the zookeeper and
toystore suites are ROADMAP.md A.11(d6)."""
