"""The reference's ``tests/test_partition.py`` checks of the process-spanning
mesh, ported: the per-shard assembly path (``force_assemble``), the mesh
gauges, the ``mesh_shards`` capacity planner and admission verdict, the
``S2C_MESH_HOSTS`` server setting and the ``s2c_mesh_*`` OpenMetrics
family, each held against the JAX package's result on the same inputs.

The two capacity models price different buffers (the port's own: the
tile-padded counts, the pinned staging ring, K1's plan), so the planner is
compared in two ways: on the same components (both modules' model
replaced by one table, where the plans must be equal) and on each
package's own model, where the verdicts must be.
"""

import gc
import re

import numpy as np
import pytest

from sam2consensus_torch import observability as t_obs
from sam2consensus_torch.observability import memplane as t_mp
from sam2consensus_torch.observability import telemetry as t_tel
from sam2consensus_torch.observability.metrics import (MetricsRegistry,
                                                       pop_run, push_run)
from sam2consensus_torch.parallel import mesh as t_mesh
from sam2consensus_torch.parallel import partition as t_part
from sam2consensus_torch.serve.admission import (REASON_CAPACITY,
                                                 AdmissionController)


@pytest.fixture(autouse=True)
def _fresh_planes():
    """Fresh memory planes; no automatic collection during a test (the JAX
    package's registry lock and memplane finalizers deadlock, ROADMAP
    §C 2)."""
    from sam2consensus_tpu.observability import memplane as r_mp

    gc.disable()
    t_mp._reset_for_tests()
    r_mp._reset_for_tests()
    try:
        yield
    finally:
        t_mp._reset_for_tests()
        r_mp._reset_for_tests()
        gc.enable()
        gc.collect()


def _r_mp():
    from sam2consensus_tpu.observability import memplane

    return memplane


# -- the shard path ------------------------------------------------------------
@pytest.mark.parametrize("pos", [("dp", "sp"), ("sp", "dp")])
def test_force_assemble_round_trips_and_bills_local_bytes(pos):
    """On one process the "local window" is the whole array: the per-shard
    assembly bills ``arr.nbytes`` to ``mesh/shard_bytes/0``, as the
    reference's does, and gathers back exactly."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sam2consensus_tpu.observability.metrics import pop_run as r_pop
    from sam2consensus_tpu.observability.metrics import push_run as r_push
    from sam2consensus_tpu.parallel import partition as r_part
    from sam2consensus_tpu.parallel.mesh import make_mesh as r_make_mesh

    arr = np.arange(64 * 6, dtype=np.int32).reshape(64, 6)
    mesh = t_mesh.make_mesh(8, ["cpu"] * 8)
    spec = t_part.Spec(t_part.POSITION, pos, 0)
    reg = push_run()
    try:
        placed = t_part.shard_to_mesh(arr, mesh, spec, force_assemble=True)
        billed = reg.value("mesh/shard_bytes/0")
    finally:
        pop_run(reg)
    with r_make_mesh(8) as rm:
        rreg = r_push()
        try:
            r_part.shard_to_mesh(arr, NamedSharding(rm, P(pos, None)),
                                 force_assemble=True)
            want = rreg.value("mesh/shard_bytes/0")
        finally:
            r_pop(rreg)
    assert billed == want == arr.nbytes
    assert np.array_equal(t_part.gather_from_mesh(placed, mesh, spec), arr)


def test_mesh_gauges():
    from sam2consensus_tpu.observability.metrics import pop_run as r_pop
    from sam2consensus_tpu.observability.metrics import push_run as r_push
    from sam2consensus_tpu.parallel import partition as r_part
    from sam2consensus_tpu.parallel.mesh import make_mesh as r_make_mesh

    mesh = t_mesh.make_mesh(8, ["cpu"] * 8)
    assert t_part.mesh_process_count(mesh) == 1
    reg = push_run()
    try:
        t_part.publish_mesh_gauges(mesh)
        got = (reg.value("mesh/hosts"), reg.value("mesh/shards"))
    finally:
        pop_run(reg)
    with r_make_mesh(8) as rm:
        assert r_part.mesh_process_count(rm) == 1
        rreg = r_push()
        try:
            r_part.publish_mesh_gauges(rm)
            want = (rreg.value("mesh/hosts"), rreg.value("mesh/shards"))
        finally:
            r_pop(rreg)
    assert got == want == (1, 8)


# -- the planner ---------------------------------------------------------------
def _two_host_budget(mp, total_len=200_000, max_hosts=4):
    """The reference's budget: strictly between the 1-host and 2-host
    per-host peaks of ``mp``'s model."""
    probe = mp.plan_mesh_shards(total_len, None, budget_bytes=0,
                                max_hosts=max_hosts, record=False)
    alt = probe["alternatives"]
    return int((alt["1"] + alt["2"]) / 2)


CASES = {"minimal_k": lambda mp: _two_host_budget(mp),
         "over_capacity": lambda mp: 1,
         "within_budget": lambda mp: 2 ** 40}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_equals_reference_on_the_same_components(monkeypatch, case):
    """Both planners over one table of components (the reference's model's
    at 200,000 positions): the same plan, key for key."""
    r_mp = _r_mp()
    _total, comp = r_mp.predict_run_peak_bytes(200_000)

    def model(*_a, **_k):
        return sum(comp.values()), dict(comp)

    monkeypatch.setattr(t_mp, "predict_run_peak_bytes", model)
    monkeypatch.setattr(r_mp, "predict_run_peak_bytes", model)
    budget = CASES[case](r_mp)
    got = t_mp.plan_mesh_shards(200_000, None, budget_bytes=budget,
                                max_hosts=4, record=False)
    want = r_mp.plan_mesh_shards(200_000, None, budget_bytes=budget,
                                 max_hosts=4, record=False)
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_verdict_equals_reference_on_own_models(case):
    """Each package over its own model: the reference's checks hold for
    both, and the verdicts agree (minimal K 2, the cap when over
    capacity, one host within budget; string keys 1-4)."""
    plans = []
    for mp in (t_mp, _r_mp()):
        plan = mp.plan_mesh_shards(200_000, None,
                                   budget_bytes=CASES[case](mp),
                                   max_hosts=4, record=False)
        assert set(plan["alternatives"]) == {"1", "2", "3", "4"}
        if case == "minimal_k":
            assert plan["per_host_bytes"] <= plan["budget_bytes"] \
                < plan["single_host_bytes"]
        plans.append((plan["fits"], plan["hosts"]))
    want = {"minimal_k": (True, 2), "over_capacity": (False, 4),
            "within_budget": (True, 1)}[case]
    assert plans[0] == plans[1] == want


def test_plan_records_ledger_decision():
    """The ``mesh_shards`` decision: chosen ``hosts_2``, the per-host
    prediction joined against the tracked peak, no drift (band 0), as the
    reference's."""
    from sam2consensus_tpu import observability as r_obs

    out = []
    for obs_, mp in ((t_obs, t_mp), (r_obs, _r_mp())):
        budget = _two_host_budget(mp)
        robs = obs_.start_run()
        try:
            mp.plan_mesh_shards(200_000, None, budget_bytes=budget,
                                max_hosts=4)
            mp.track("counts", 50_000)
            recs = obs_.finalize_decisions()
        finally:
            obs_.finish_run(robs)
        rec = next(r for r in recs if r.decision == "mesh_shards")
        assert rec.predicted["per_host_bytes"] > 0
        out.append((rec.chosen, rec.measured["per_host_bytes"], rec.drift,
                    sorted(rec.alternatives)))
    assert out[0] == out[1] == ("hosts_2", 50_000, False,
                                ["1", "2", "3", "4"])


def test_admission_verdict_matrix():
    """The port's ``AdmissionController`` (a pinned copy) against the
    reference's on the reference's matrix."""
    from sam2consensus_tpu.serve.admission import \
        AdmissionController as RAdmission

    fits2 = {"fits": True, "hosts": 2}
    calls = [dict(predicted_bytes=50), dict(predicted_bytes=500),
             dict(predicted_bytes=500, shard_plan=fits2),
             dict(predicted_bytes=500, shard_plan={"fits": False,
                                                   "hosts": 4}),
             dict(predicted_bytes=500, shard_plan={"fits": True,
                                                   "hosts": 1})]
    got = [(d.admitted, d.reason, d.mesh_shards) for d in (
        AdmissionController(mem_budget=100, mesh_hosts=4).admit("t", **kw)
        for kw in calls)]
    want = [(d.admitted, d.reason, d.mesh_shards) for d in (
        RAdmission(mem_budget=100, mesh_hosts=4).admit("t", **kw)
        for kw in calls)]
    assert got == want
    assert got[0][0] and got[0][2] is None
    assert got[1][1] == got[3][1] == got[4][1] == REASON_CAPACITY
    assert got[2][0] and got[2][2] == 2
    assert AdmissionController().admit("t", predicted_bytes=500).admitted


def test_mesh_hosts_env(monkeypatch):
    from sam2consensus_torch.serve import ServeRunner
    from sam2consensus_tpu.serve import ServeRunner as RServeRunner

    monkeypatch.setenv("S2C_JIT_CACHE", "")
    monkeypatch.setenv("S2C_MESH_HOSTS", "3")
    r = ServeRunner(prewarm="off", device="cpu")
    try:
        assert r.admission.mesh_hosts == 3
    finally:
        r.close()
    rr = RServeRunner(prewarm="off", persistent_cache=False)
    assert rr.admission.mesh_hosts == 3
    monkeypatch.setenv("S2C_MESH_HOSTS", "lots")
    with pytest.raises(ValueError,
                       match="S2C_MESH_HOSTS must be an integer") as got:
        ServeRunner(prewarm="off", device="cpu")
    with pytest.raises(ValueError) as want:
        RServeRunner(prewarm="off", persistent_cache=False)
    assert str(got.value) == str(want.value)


def test_over_budget_job_admitted_with_mesh_verdict(tmp_path, monkeypatch):
    """The runner prices an over-budget job with ``plan_mesh_shards``: under
    ``S2C_MESH_HOSTS=2`` and a budget between the 1-host and 2-host
    figures it is admitted with ``mesh_shards`` 2 (stamped into the
    journal's ``submitted`` record, ``serve/admission_mesh`` and
    ``mesh/planned_hosts`` set, the health snapshot's mesh section), runs
    on this server and writes the reference's FASTA; without the variable
    it is shed as ``capacity``."""
    import json
    import os

    from sam2consensus_torch.config import RunConfig
    from sam2consensus_torch.io.fasta import render_file
    from sam2consensus_torch.serve import JobSpec, ServeRunner
    from sam2consensus_torch.serve.health import snapshot
    from sam2consensus_torch.utils.simulate import SimSpec, simulate
    from sam2consensus_tpu.backends.cpu import CpuBackend
    from sam2consensus_tpu.config import RunConfig as RConfig
    from sam2consensus_tpu.io.fasta import render_file as r_render
    from sam2consensus_tpu.io.sam import iter_records, read_header

    text = simulate(SimSpec(n_contigs=1, contig_len=3000, n_reads=400,
                            read_len=100, contig_len_jitter=0.0, seed=16))
    path = os.path.join(str(tmp_path), "mesh.sam")
    with open(path, "w") as fh:
        fh.write(text)
    import io as _io

    handle = _io.StringIO(text)
    contigs, _n, first = read_header(handle)
    total_len = sum(c.length for c in contigs)
    cfg = RunConfig(outfolder=str(tmp_path / "out"), prefix="m")
    plan = t_mp.plan_mesh_shards(total_len, cfg, max_hosts=2, record=False)
    budget = int((plan["alternatives"]["1"]
                  + plan["alternatives"]["2"]) // 2)
    ref = CpuBackend().run(contigs, iter_records(handle, first),
                           RConfig(prefix="m"))
    want = {n: r_render(r, 0) for n, r in ref.fastas.items()}

    monkeypatch.setenv("S2C_MESH_HOSTS", "2")
    jdir = str(tmp_path / "journal")
    r = ServeRunner(prewarm="off", device="cpu", mem_budget=str(budget),
                    journal_dir=jdir)
    try:
        (res,) = r.submit_jobs([JobSpec(path, cfg)])
        assert res.ok
        assert {n: render_file(x, 0) for n, x in res.fastas.items()} == want
        assert r.registry.value("serve/admission_mesh") == 1
        assert r.registry.value("mesh/planned_hosts") == 2
        snap = snapshot(r)
        assert snap["mesh"]["planned_hosts"] == 2
        assert snap["mesh"]["mesh_hosts_capacity"] == 2
        assert snap["mesh"]["admitted_mesh"] == 1
    finally:
        r.close()
    events = []
    for root, _dirs, files in os.walk(jdir):
        for name in files:
            try:
                with open(os.path.join(root, name)) as fh:
                    events.append(json.load(fh))
            except (ValueError, UnicodeDecodeError):
                pass
    (sub,) = [e for e in events if isinstance(e, dict)
              and e.get("ev") == "submitted"]
    assert sub["mesh_shards"] == 2

    monkeypatch.delenv("S2C_MESH_HOSTS")
    r = ServeRunner(prewarm="off", device="cpu", mem_budget=str(budget))
    try:
        (res,) = r.submit_jobs([JobSpec(path, cfg)])
        assert not res.ok and res.admission == REASON_CAPACITY
    finally:
        r.close()


# -- the s2c_mesh_* OpenMetrics family ----------------------------------------
def test_mesh_openmetrics_family():
    """The port's exposition of the mesh counters and gauges: the
    reference's family lines and a clean lint, and the same lines as the
    reference's renderer on the same registry contents."""
    from sam2consensus_tpu.observability import telemetry as r_tel
    from sam2consensus_tpu.observability.metrics import \
        MetricsRegistry as RRegistry

    texts = []
    for reg_cls, tel in ((MetricsRegistry, t_tel), (RRegistry, r_tel)):
        r = reg_cls()
        r.add("mesh/shard_bytes/0", 1024)
        r.add("mesh/shard_bytes/1", 2048)
        r.add("mesh/gather_bytes", 4096)
        r.add("serve/admission_mesh", 1)
        r.gauge("mesh/hosts").set(2)
        r.gauge("mesh/shards").set(8)
        r.gauge("mesh/planned_hosts").set(2)
        texts.append(tel.render_openmetrics(r.snapshot()))
        assert tel.lint_openmetrics(texts[-1]) == []
    text = texts[0]
    for pat in (r's2c_mesh_shard_bytes_total\{host="0"\} 1024',
                r's2c_mesh_shard_bytes_total\{host="1"\} 2048',
                r"s2c_mesh_gather_bytes_total 4096",
                r"s2c_mesh_hosts 2(\.0)?\b", r"s2c_mesh_shards 8(\.0)?\b",
                r"s2c_mesh_planned_hosts 2(\.0)?\b",
                r"s2c_serve_admission_mesh_total 1\b"):
        assert re.search(pat, text), pat

    def mesh_lines(t):
        return sorted(line for line in t.splitlines()
                      if "s2c_mesh" in line or "admission_mesh" in line)

    assert mesh_lines(texts[0]) == mesh_lines(texts[1])
