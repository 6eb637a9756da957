"""The port's perf trend gate (``jepsen_tpu_torch/obs/trend.py``) and
planlint's PL022 trend pass against the JAX package's.

``compare`` and the ``gate`` command get the same records in both
packages and must give the same verdicts and the same JSON; ``record``
and ``load`` write and read the same log (the wall stamp ``t`` is
masked). The fingerprint is the port's own (ROADMAP.md, deliberate
divergences): the torch build, the CUDA device's name, capability and
count, ``CUDA_VISIBLE_DEVICES`` and the hostname; its probe is
contained. ``mini_bench`` runs the port's key batch on the CPU here
(``device="cpu"``; on the card ``chip_smoke.py``'s campaign phase runs
it). Tolerance: equality."""

import json

import pytest
import torch

from jepsen_tpu.analysis import planlint as jplanlint
from jepsen_tpu.obs import trend as jtrend
from jepsen_tpu_torch.analysis import planlint as tplanlint
from jepsen_tpu_torch.obs import phases as obs_phases
from jepsen_tpu_torch.obs import trend as ttrend


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rec(samples, fp=None, rung="mini-cas-batch", metric="ops_per_s"):
    return {"t": 0, "fingerprint": fp or {"host": "a"},
            "rungs": {rung: {"metrics": {metric: max(samples)},
                             "samples": {metric: list(samples)}}}}


COMPARE_CASES = {
    "within-allowance": ([_rec([100.0, 90.0]), _rec([98.0, 95.0])],
                         _rec([85.0]), {}),
    "real-drop": ([_rec([100.0, 90.0]), _rec([98.0, 95.0])],
                  _rec([60.0]), {}),
    "noisy-baseline": ([_rec([100.0, 50.0])], _rec([55.0]), {}),
    "cross-env": ([_rec([100.0], fp={"host": "elsewhere"})],
                  _rec([10.0], fp={"host": "here"}), {}),
    "mixed-env": ([_rec([100.0], fp={"host": "b"}), _rec([90.0])],
                  _rec([60.0]), {}),
    "threshold": ([_rec([100.0])], _rec([85.0]), {"threshold": 0.1}),
    "threshold-none": ([_rec([100.0])], _rec([70.0]),
                       {"threshold": None}),
    "other-metric": ([_rec([100.0], metric="duty_cycle")],
                     _rec([1.0], metric="duty_cycle"), {}),
    "metrics-only": ([{"t": 0, "fingerprint": {"host": "a"},
                       "rungs": {"r": {"metrics": {"ops_per_s": 50}}}}],
                     _rec([30.0], rung="r"), {}),
    "zero-baseline": ([_rec([0.0])], _rec([1.0]), {}),
    "empty": ([], _rec([1.0]), {}),
}


@pytest.mark.parametrize("name", sorted(COMPARE_CASES))
def test_compare_equal(name):
    baseline, current, kw = COMPARE_CASES[name]
    assert ttrend.compare(baseline, current, **kw) == \
        jtrend.compare(baseline, current, **kw)


def test_compare_verdicts():
    base, cur, _ = COMPARE_CASES["real-drop"]
    bad = ttrend.compare(base, cur)
    assert bad["regressions"][0]["drop_frac"] == pytest.approx(0.4)
    v = ttrend.compare(*COMPARE_CASES["cross-env"][:2])
    assert v["compared"] == 0 and v["skipped_mismatched_env"] == 1


def test_record_load_and_gate_equal(tmp_path, capsys):
    """The same records written by each package's ``record`` read back
    alike, and ``gate`` gives the same exit codes and JSON lines."""
    fp = {"host": "a"}
    outs = {}
    for name, trend in (("jax", jtrend), ("torch", ttrend)):
        p = str(tmp_path / f"{name}.jsonl")
        lines = []
        codes = [trend.main(["gate", "--path", p])]   # no records
        lines.append(capsys.readouterr().out)
        trend.record(_rec([100.0, 95.0])["rungs"], path=p, fp=fp)
        trend.record(_rec([99.0])["rungs"], path=p, fp=fp, label="aa")
        codes.append(trend.main(["gate", "--path", p]))
        lines.append(capsys.readouterr().out)
        trend.record(_rec([40.0])["rungs"], path=p, fp=fp)
        codes.append(trend.main(["gate", "--path", p, "--window", "1"]))
        lines.append(capsys.readouterr().out)
        trend.record(_rec([50.0])["rungs"], path=p, fp={"host": "b"})
        codes.append(trend.main(["gate", "--path", p, "--threshold",
                                 "0.5"]))
        lines.append(capsys.readouterr().out)
        with open(p, "a") as f:
            f.write("[\n{not json\n]\n")
        recs = [dict(r, t=0) for r in trend.load(p)]
        outs[name] = (codes, lines, recs)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == [0, 0, 1, 0]
    assert ttrend.load(str(tmp_path / "missing.jsonl")) == []


def test_fingerprint_names_the_torch_device_and_is_contained(monkeypatch):
    a, b = ttrend.fingerprint(), ttrend.fingerprint()
    assert a == b
    json.dumps(a)
    assert set(a) == {"hostname", "cuda_visible_devices", "torch",
                      "platform", "device", "capability", "device_count"}
    assert a["torch"] == torch.__version__
    assert a["platform"] == ("cuda" if torch.cuda.is_available()
                             else "cpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    assert ttrend.fingerprint()["cuda_visible_devices"] == "3"

    def broken():
        raise RuntimeError("no driver")

    monkeypatch.setattr(torch.cuda, "is_available", broken)
    fp = ttrend.fingerprint()
    assert fp["torch"] == torch.__version__ and fp["platform"] is None
    # a baseline from another fingerprint is refused, never compared
    v = ttrend.compare([_rec([100.0], fp=a)], _rec([1.0], fp=fp))
    assert v["compared"] == 0 and v["skipped_mismatched_env"] == 1


def test_mini_bench_shape_on_the_cpu(monkeypatch):
    from jepsen_tpu_torch.checker import rollout
    rollout.launches = 0
    rungs = ttrend.mini_bench(n_keys=2, n_ops=40, repeats=2, device="cpu")
    r = rungs["mini-cas-batch"]
    assert len(r["samples"]["ops_per_s"]) == 2
    assert r["metrics"]["ops_per_s"] == max(r["samples"]["ops_per_s"])
    assert r["metrics"]["keys"] == 2 and r["metrics"]["ops"] > 0
    assert 0.0 <= r["metrics"]["duty_cycle"] <= 1.0
    assert set(r["phase_s"]) <= set(obs_phases.PHASES)
    assert "device" in r["phase_s"]
    assert rollout.launches == 0         # the key batch pins the scan
    # the injected slowdown lands inside the measured region
    monkeypatch.setenv(ttrend.INJECT_ENV, "200")
    slow = ttrend.mini_bench(n_keys=2, n_ops=40, repeats=1,
                             device="cpu")["mini-cas-batch"]
    assert slow["metrics"]["ops_per_s"] < r["metrics"]["ops_per_s"]


def test_record_command_runs_the_rung_on_the_asked_device(tmp_path,
                                                          capsys):
    p = str(tmp_path / "t.jsonl")
    assert ttrend.main(["record", "--path", p, "--repeats", "1",
                        "--label", "cpu", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["label"] == "cpu" and rec["fingerprint"] == \
        ttrend.fingerprint()
    assert ttrend.load(p)[0]["rungs"] == rec["rungs"]


PL022 = [
    {},
    {"phases?": False, "profile?": True, "bubbles?": True},
    {"phases?": True, "profile?": True},
    {"trend-gate-threshold": 0},
    {"trend-gate-threshold": -1},
    {"trend-gate-threshold": "fast"},
    {"trend-gate-threshold": True},
    {"trend-gate-threshold": 0.3},
    "not a map",
]


@pytest.mark.parametrize("cfg", PL022, ids=[f"c{i}" for i in
                                            range(len(PL022))])
def test_pl022_equal(cfg):
    ours = [d.to_dict() for d in tplanlint.lint_trend(cfg)]
    theirs = [d.to_dict() for d in jplanlint.lint_trend(cfg)]
    assert ours == theirs


def test_pl022_baselines(tmp_path):
    """An unreadable baseline is the same error in both; a readable one
    from another environment warns in both; one recorded here lints
    clean (each package against its own fingerprint). The warning names
    torch builds where the reference names jax builds."""
    missing = str(tmp_path / "nope.jsonl")
    ours = tplanlint.lint_trend({"trend-baseline": missing})
    theirs = jplanlint.lint_trend({"trend-baseline": missing})
    assert [(d.code, d.severity, d.location) for d in ours] == \
        [(d.code, d.severity, d.location) for d in theirs]
    assert ours[0].severity == "error"
    assert "jepsen_tpu_torch.obs.trend record" in ours[0].fix_hint
    p = tmp_path / "trend.jsonl"
    p.write_text(json.dumps({"t": 0, "fingerprint":
                             {"hostname": "not-this-box"},
                             "rungs": {}}) + "\n")
    ours = tplanlint.lint_trend({"trend-baseline": str(p)})
    theirs = jplanlint.lint_trend({"trend-baseline": str(p)})
    assert [(d.code, d.severity, d.location) for d in ours] == \
        [(d.code, d.severity, d.location) for d in theirs] == \
        [("PL022", "warning", "plan.trend-baseline")]
    for plan, trend in ((tplanlint, ttrend), (jplanlint, jtrend)):
        p.write_text(json.dumps({"t": 0, "fingerprint":
                                 trend.fingerprint(), "rungs": {}}) + "\n")
        assert plan.lint_trend({"trend-baseline": str(p)}) == []
    t = {"name": "x", "phases?": False, "profile?": True}
    assert any(d.code == "PL022" for d in tplanlint.lint_plan(t))
