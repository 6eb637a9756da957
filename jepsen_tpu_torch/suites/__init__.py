"""Exemplar consumer suites: complete, runnable tests for real systems,
built on the framework the way the reference's per-database projects are
(SURVEY.md §2.8 — e.g. zookeeper.clj as the minimal single-file example,
tidb/core.clj for the workload-registry pattern). The port's copy of
``jepsen_tpu/suites``: etcd, txn, zookeeper (with its wire protocol,
``zk_proto``) and toystore, each run as ``python -m
jepsen_tpu_torch.suites.<name> test ... --device {cuda,cpu}``."""
