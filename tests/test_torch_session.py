"""The port's streaming sessions on the CPU, held against the JAX package.

The same waves through the port's ``SessionManager`` and the reference's
give the same ACKs, digests, outputs and journal events (timestamps,
worker names and session ids aside), and the port's closed session writes
the JAX package's one-shot bytes over all its reads.  The rejection
paths (a declared-sha mismatch, malformed and empty waves, a torn spool,
backpressure, an unknown session), stability and re-vote, the HTTP
status taxonomy through ``IngestServer``, orphan adoption with replay of
an uncovered wave, the stale rejection that must not void a later ACKed
wave (``tests/test_session.py``'s review case) and the session flag
cross-checks of the serve CLI behave as the reference's.  Each wave's
run takes its seed and gives back its state through its own
``CountCapture`` box, and each run's record lands in ``waves.jsonl``.
"""

import dataclasses
import hashlib
import http.client
import json
import os
import time

import pytest

from sam2consensus_torch.config import RunConfig as TConfig
from test_torch_serve import _collect_jax_garbage, jax_cold  # noqa: F401


def _corpus(tmp_path, n_waves=3, n_reads=900, contig_len=2200, seed=411,
            prefix="ts_", **kw):
    from sam2consensus_torch.utils.simulate import SimSpec, simulate

    text = simulate(SimSpec(n_contigs=1, contig_len=contig_len,
                            n_reads=n_reads, read_len=100,
                            contig_len_jitter=0.0, seed=seed,
                            contig_prefix=prefix, **kw))
    header = [ln for ln in text.splitlines() if ln.startswith("@")]
    reads = [ln for ln in text.splitlines()
             if ln and not ln.startswith("@")]
    per = max(1, len(reads) // n_waves)
    waves = [reads[i:i + per] for i in range(0, len(reads), per)]
    if len(waves) > n_waves:
        waves[n_waves - 1].extend(ln for w in waves[n_waves:] for ln in w)
        waves = waves[:n_waves]
    concat = str(tmp_path / "concat.sam")
    with open(concat, "w") as fh:
        fh.write(text)
    return ("\n".join(header) + "\n",
            [("\n".join(w) + "\n").encode("utf-8") for w in waves], concat)


class _Side:
    """One package's session stack: a fleet worker's runner on a journal
    under ``root``, its ``SessionManager`` and its session module."""

    def __init__(self, tag, root, worker="w0", ttl=30.0, base=None,
                 **mgr_kw):
        import importlib

        pkg = {"t": "sam2consensus_torch", "r": "sam2consensus_tpu"}[tag]
        self.tag = tag
        self.mod = importlib.import_module(f"{pkg}.serve.session")
        serve = importlib.import_module(f"{pkg}.serve")
        out = os.path.join(root, "oneshot_out")
        os.makedirs(out, exist_ok=True)
        if tag == "t":
            self.runner = serve.ServeRunner(
                prewarm="off", persistent_cache=False, device="cpu",
                journal_dir=os.path.join(root, "j"), worker_id=worker,
                lease_ttl=ttl)
            cfg = TConfig(outfolder=out + os.sep, prefix="",
                          **(base or {}))
        else:
            from sam2consensus_tpu.config import RunConfig

            self.runner = serve.ServeRunner(
                prewarm="off", persistent_cache=False,
                journal_dir=os.path.join(root, "j"), worker_id=worker,
                lease_ttl=ttl)
            cfg = RunConfig(backend="jax", outfolder=out + os.sep,
                            prefix="")
        self.cfg = cfg
        self.mgr = self.mod.SessionManager(self.runner, cfg, **mgr_kw)
        self.runner.sessions = self.mgr

    def close(self):
        self.runner.close()


def _both(tmp_path, fn, **kw):
    """``fn(side)`` on each package's stack; the two outcomes."""
    outs = []
    for tag in ("t", "r"):
        side = _Side(tag, str(tmp_path / tag), **kw)
        try:
            outs.append(fn(side))
        finally:
            side.close()
    return outs


def _sha(body):
    return "sha256:" + hashlib.sha256(body).hexdigest()


def _err(fn, *a, **k):
    """A call's outcome: its result, or the SessionError's fields."""
    try:
        return ("ok", fn(*a, **k))
    except Exception as exc:
        if type(exc).__name__ != "SessionError":
            raise
        return ("error", exc.status, exc.reason,
                exc.retry_after is not None and exc.retry_after > 0)


def _norm_events(events, sid):
    """Journal events without wall times, sequence numbers, lease
    expiries and the session id / worker names that differ by run."""
    drop = {"t", "seq", "schema", "expires_unix", "claim_seq"}
    out = []
    for e in events:
        rec = {k: v for k, v in e.items() if k not in drop}
        for k in ("key", "job"):
            if rec.get(k) == sid:
                rec[k] = "SID"
        if isinstance(rec.get("outputs"), dict):
            rec["outputs"] = sorted(os.path.basename(p).replace(sid, "SID")
                                    for p in rec["outputs"])
        out.append(rec)
    return out


def _contents(paths):
    res = {}
    for p in paths:
        with open(p, "rb") as fh:
            res[os.path.basename(p).split("__")[0]] = fh.read()
    return res


# -- the wave stream ---------------------------------------------------------
@pytest.mark.parametrize("pileup", ["auto", "pallas"])
def test_wave_stream_equals_reference_and_one_shot(tmp_path, pileup):
    header, bodies, concat = _corpus(tmp_path, ins_read_rate=0.2)
    base = {"pileup": pileup, "ins_kernel": "pallas"} \
        if pileup == "pallas" else {}

    def stream(side):
        m = side.mgr
        sid = m.open_session(header, tenant="t0")["sid"]
        acks = []
        for body in bodies:
            ack = m.receive_wave(sid, body, declared_sha=_sha(body))
            acks.append({k: v for k, v in ack.items() if k != "sid"})
        res = m.close_session(sid)
        audit = side.runner.journal.audit(full=True)["sessions"][sid]
        log = None
        if side.tag == "t":
            with open(os.path.join(m.sessions_root, sid,
                                   side.mod.WAVE_LOG)) as fh:
                log = [json.loads(ln) for ln in fh]
        return (acks, res["digest"], res["reads_total"], res["waves"],
                _contents(res["outputs"]), audit,
                _norm_events(side.runner.journal.events(), sid),
                side.runner.health_snapshot()["sessions"]["waves_absorbed"],
                log)

    t, r = _both(tmp_path, stream, base=base, stability_waves=99,
                 revote_debounce=0.0)
    assert t[:8] == r[:8]
    acks, digest, _n, _w, contents, audit, events, absorbed, log = t
    assert [a["status"] for a in acks] == ["absorbed"] * 3
    assert audit["lost_waves"] == [] and audit["duplicated_waves"] == []
    assert absorbed == 3
    kinds = [e["ev"] for e in events]
    assert kinds[:2] == ["claimed", "session_open"]
    assert kinds[-1] == "session_closed"
    # the closed session's FASTA is the JAX package's one-shot over
    # every read of every wave
    want = jax_cold(concat, TConfig(prefix=""))
    assert {k: v.decode() for k, v in contents.items()} == want
    # one record a backend run, each wave seeded from the last state
    # (a cold absorb first) and captured back
    assert [(x["wave"], x["revote"], x["duplicate"]) for x in log] == \
        [(1, False, False), (2, False, False), (3, False, False)]
    assert all(x["save_sec"] > 0 and x["journal_sec"] > 0 for x in log)


def test_session_seeds_through_count_capture_boxes(tmp_path):
    """Every wave's run gets a fresh ``CountCapture`` box holding the
    session's state; the backend carries no seed or result registers."""
    from sam2consensus_torch.backends.torch_backend import CountCapture

    header, bodies, _ = _corpus(tmp_path, n_waves=2)
    side = _Side("t", str(tmp_path / "t"), stability_waves=99)
    boxes = []
    real = side.runner._plant_seed

    def plant(seed):
        box = real(seed)
        boxes.append((box, seed))
        return box

    side.runner._plant_seed = plant
    try:
        sid = side.mgr.open_session(header)["sid"]
        for body in bodies:
            side.mgr.receive_wave(sid, body)
        side.mgr.revote(sid)
    finally:
        side.close()
    assert len(boxes) == 3
    assert all(isinstance(b, CountCapture) for b, _ in boxes)
    assert len({id(b) for b, _ in boxes}) == 3
    assert boxes[0][1] is None                      # a cold first absorb
    assert boxes[1][1] is boxes[0][0].result        # wave 1's state
    assert boxes[2][1] is boxes[1][0].result        # the re-vote's seed
    assert boxes[2][0].result is not None
    assert not any(hasattr(side.runner.backend, n) for n in
                   ("serve_count_seed", "serve_count_result",
                    "serve_capture_counts"))


# -- the rejection paths, stability, re-vote ---------------------------------
def scenario_sha_mismatch(side, header, bodies):
    m = side.mgr
    sid = m.open_session(header)["sid"]
    out = [_err(m.receive_wave, sid, bodies[0], declared_sha=_sha(b"x")),
           _err(m.receive_wave, sid, bodies[0],
                declared_sha=_sha(bodies[0]))[1]["status"]]
    aud = side.runner.journal.audit(full=True)["sessions"][sid]
    return out + [aud["rejected_waves"], aud["lost_waves"]]


def scenario_malformed_and_empty(side, header, bodies):
    m = side.mgr
    sid = m.open_session(header)["sid"]
    return [_err(m.receive_wave, sid, b"not\ta\tsam\trecord\n"),
            _err(m.receive_wave, sid, b"@CO just header noise\n"),
            _err(m.open_session, "@CO\tnothing here\n"),
            m.status(sid)["waves"], m.status(sid)["absorbed"]]


def scenario_torn_spool(side, header, bodies):
    m = side.mgr
    sid = m.open_session(header)["sid"]
    ack = m.receive_wave(sid, bodies[0])
    n = ack["wave"]
    with open(m.sessions[sid].body_path(n), "wb") as fh:
        fh.write(bodies[0][: len(bodies[0]) // 2])
    time.sleep(0.25)
    m.tick()
    st1 = m.status(sid)
    m.receive_wave(sid, bodies[0])
    time.sleep(0.25)
    m.tick()
    st2 = m.status(sid)
    aud = side.runner.journal.audit(full=True)["sessions"][sid]
    return [ack["status"], st1["absorbed"], st1["resend"],
            side.runner.registry.value("session/torn_waves"),
            st2["absorbed"], st2["reads_total"], aud["lost_waves"],
            aud["duplicated_waves"], aud["rejected_waves"]]


def scenario_stability_and_revote(side, header, bodies):
    m = side.mgr
    sid = m.open_session(header)["sid"]
    a0 = m.receive_wave(sid, bodies[0])
    a1 = m.receive_wave(sid, bodies[0])
    before = m.status(sid)["waves"]
    rv = m.revote(sid)
    stable = [e["ev"] for e in side.runner.journal.events()
              if e["ev"] == "session_stable"]
    return [a0["stable"], a1["stable"], a1["stable_wave"] == a1["wave"],
            a1["digest"] == a0["digest"], rv["digest"] == a1["digest"],
            m.status(sid)["waves"] == before, stable,
            side.runner.registry.value("session/revotes")]


def scenario_backpressure(side, header, bodies):
    m = side.mgr
    sid = m.open_session(header)["sid"]
    return [m.receive_wave(sid, bodies[0])["status"],
            _err(m.receive_wave, sid, bodies[1]),
            side.runner.registry.value("session/waves_shed")]


def scenario_unknown_session(side, header, bodies):
    m = side.mgr
    return [_err(m.status, "s-nope"),
            _err(m.receive_wave, "s-nope", b"x\t" * 10 + b"x\n"),
            _err(m.revote, "s-nope"), _err(m.close_session, "s-nope")]


SCENARIOS = {
    "sha_mismatch": (scenario_sha_mismatch, dict(stability_waves=99)),
    "malformed_and_empty": (scenario_malformed_and_empty, {}),
    "torn_spool": (scenario_torn_spool, dict(stability_waves=99,
                                             revote_debounce=0.2)),
    "stability_and_revote": (scenario_stability_and_revote,
                             dict(stability_waves=2)),
    "backpressure": (scenario_backpressure, dict(revote_debounce=60.0,
                                                 max_pending=1)),
    "unknown_session": (scenario_unknown_session, {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_session_paths_equal_reference(tmp_path, name):
    fn, kw = SCENARIOS[name]
    header, bodies, _ = _corpus(tmp_path, n_waves=2, n_reads=400,
                                contig_len=1200)
    t, r = _both(tmp_path, lambda side: fn(side, header, bodies), **kw)
    assert t == r
    if name == "sha_mismatch":
        assert t[0] == ("error", 422, "sha_mismatch", False)
    elif name == "torn_spool":
        assert t[1:4] == [0, [1], 1] and t[4] == 1
    elif name == "stability_and_revote":
        assert t[:2] == [False, True] and t[-1] == 1
    elif name == "backpressure":
        assert t[0] == "pending" and t[1][:3] == ("error", 429,
                                                   "backpressure")
        assert t[1][3] is True
    elif name == "unknown_session":
        assert all(o[:2] == ("error", 404) for o in t)


def test_revote_counts_nothing(tmp_path):
    """A re-vote of an absorbed wave decodes and counts nothing (the
    backend's duplicate-source skip) and leaves the digest as it was;
    its record says so."""
    header, bodies, _ = _corpus(tmp_path, n_waves=2)
    side = _Side("t", str(tmp_path / "t"), stability_waves=99,
                 base={"pileup": "pallas"})
    try:
        sid = side.mgr.open_session(header)["sid"]
        for body in bodies:
            digest = side.mgr.receive_wave(sid, body)["digest"]
        assert side.mgr.revote(sid)["digest"] == digest
        with open(os.path.join(side.mgr.sessions_root, sid,
                               side.mod.WAVE_LOG)) as fh:
            log = [json.loads(ln) for ln in fh]
    finally:
        side.close()
    assert [(x["revote"], x["duplicate"]) for x in log] == \
        [(False, False), (False, False), (True, True)]
    assert log[-1]["save_sec"] == 0.0


# -- the HTTP front door -----------------------------------------------------
def _request(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        hdrs = dict(headers or {})
        if method == "POST":
            hdrs.setdefault("Content-Length", str(len(body)))
        conn.request(method, path, body=body or None, headers=hdrs)
        resp = conn.getresponse()
        payload = resp.read()
        try:
            doc = json.loads(payload.decode("utf-8"))
        except Exception:
            doc = {}
        return resp.status, doc, dict(resp.getheaders())
    finally:
        conn.close()


def test_http_status_taxonomy_equals_reference(tmp_path):
    header, bodies, _ = _corpus(tmp_path, n_waves=2, n_reads=400,
                                contig_len=1200)

    def taxonomy(side):
        srv_mod = __import__(side.mod.__name__.rsplit(".", 1)[0]
                             + ".stream_server", fromlist=["x"])
        srv = srv_mod.IngestServer(
            side.mgr, port=0, max_body=max(len(b) for b in bodies) + 512,
            timeout=10.0)
        port = srv.port
        seen = []

        def req(method, path, body=b"", headers=None):
            st, doc, hdrs = _request(port, method, path, body, headers)
            last = path.split("/")[-1]
            seen.append((method, "SID" if last.startswith("s-") else last,
                         st, doc.get("error"), doc.get("status")))
            return st, doc, hdrs

        try:
            req("GET", "/nope")
            req("PUT", "/session/open")
            req("POST", "/session/x/frob")
            req("GET", "/session/s-missing")
            req("POST", "/session/open", b"@CO\tnothing here\n")
            _, doc, _ = req("POST", "/session/open",
                            header.encode("utf-8"), {"X-Tenant": "net0"})
            sid = doc["sid"]
            req("POST", f"/session/{sid}/wave", bodies[0],
                {"X-Wave-Sha256": "sha256:" + "f" * 64})
            req("POST", f"/session/{sid}/wave", b"x" * (srv.max_body + 1))
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=15)
            try:
                conn.putrequest("POST", f"/session/{sid}/wave")
                conn.endheaders()
                seen.append(("POST", "no-length",
                             conn.getresponse().status))
            finally:
                conn.close()
            _, wave, _ = req("POST", f"/session/{sid}/wave", bodies[0],
                             {"X-Wave-Sha256": _sha(bodies[0])})
            _, rv, _ = req("POST", f"/session/{sid}/revote")
            seen.append(("digest", rv["digest"] == wave["digest"] != ""))
            _, st, _ = req("GET", f"/session/{sid}")
            seen.append(("absorbed", st["absorbed"]))
            _, hs, _ = req("GET", "/sessions")
            seen.append(("health", hs["open"], hs["waves_rejected"] >= 1))
            _, closed, _ = req("POST", f"/session/{sid}/close")
            seen.append(("outputs", len(closed["outputs"])))
            req("POST", f"/session/{sid}/wave", bodies[1])
        finally:
            srv.close()
        return seen

    t, r = _both(tmp_path, taxonomy, stability_waves=99)
    assert t == r
    statuses = [x[2] for x in t if x[0] in ("GET", "POST", "PUT")]
    assert statuses == [404, 405, 404, 404, 422, 200, 422, 413, 400, 200,
                        200, 200, 200, 200, 404]


def test_http_backpressure_carries_retry_after(tmp_path):
    header, bodies, _ = _corpus(tmp_path, n_waves=2, n_reads=400,
                                contig_len=1200)

    def pressure(side):
        srv_mod = __import__(side.mod.__name__.rsplit(".", 1)[0]
                             + ".stream_server", fromlist=["x"])
        srv = srv_mod.IngestServer(side.mgr, port=0, max_body=1 << 20,
                                   timeout=10.0)
        try:
            _, doc, _ = _request(srv.port, "POST", "/session/open",
                                 header.encode("utf-8"))
            sid = doc["sid"]
            a = _request(srv.port, "POST", f"/session/{sid}/wave",
                         bodies[0])
            b = _request(srv.port, "POST", f"/session/{sid}/wave",
                         bodies[1])
        finally:
            srv.close()
        return [a[0], a[1]["status"], b[0], b[1]["error"],
                b[2].get("Retry-After")]

    t, r = _both(tmp_path, pressure, revote_debounce=60.0, max_pending=1)
    assert t == r
    assert t[:4] == [202, "pending", 429, "backpressure"]
    assert float(t[4]) > 0


# -- recovery ------------------------------------------------------------------
def _adopt(side_b, sid):
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        side_b.mgr.tick()
        if sid in side_b.mgr.sessions:
            return True
        time.sleep(0.2)
    return False


def test_peer_adopts_orphan_and_replays_uncovered_wave(tmp_path):
    """Worker w0 absorbs two waves, journals a third (spool + intent)
    and dies before absorbing it; w1 adopts the session once the lease
    expires, replays exactly that wave and closes with every read
    counted once, the JAX package's one-shot bytes — on both packages
    alike."""
    header, bodies, concat = _corpus(tmp_path)

    def run(tag):
        root = str(tmp_path / tag)
        a = _Side(tag, root, worker="w0", ttl=0.6, stability_waves=99)
        sid = a.mgr.open_session(header, tenant="tr")["sid"]
        for body in bodies[:2]:
            assert a.mgr.receive_wave(sid, body)["status"] == "absorbed"
        sess = a.mgr.sessions[sid]
        n = sess.wave_next
        with open(sess.body_path(n), "wb") as fh:
            fh.write(bodies[2])
        a.runner.journal.append(
            "wave_received", key=sid, wave=n,
            sha=a.mod.sha256_hex(bodies[2]),
            reads=a.mod._count_reads(bodies[2]), bytes=len(bodies[2]))
        expected = sum(a.mod._count_reads(b) for b in bodies)
        a.close()
        b = _Side(tag, root, worker="w1", ttl=0.6, stability_waves=99)
        try:
            assert _adopt(b, sid), "peer never adopted the orphan"
            st = b.mgr.status(sid)
            res = b.mgr.close_session(sid)
            aud = b.runner.journal.audit(full=True)["sessions"][sid]
            return [st["stolen_from"], st["absorbed"],
                    st["reads_total"] == expected, aud["lost_waves"],
                    aud["duplicated_waves"],
                    b.runner.registry.value("session/steals"),
                    _contents(res["outputs"])]
        finally:
            b.close()

    t, r = run("t"), run("r")
    assert t == r
    assert t[:6] == ["w0", 3, True, [], [], 1]
    want = jax_cold(concat, TConfig(prefix=""))
    assert {k: v.decode() for k, v in t[6].items()} == want


def test_rejection_never_voids_a_later_acked_wave(tmp_path):
    """A torn upload is rejected 422, the client re-sends and gets a 202,
    the worker dies before absorbing: the thief replays the ACKed wave
    (the rejection consumed its own wave number)."""
    header, bodies, _ = _corpus(tmp_path, n_waves=2)

    def run(tag):
        root = str(tmp_path / tag)
        a = _Side(tag, root, worker="w0", ttl=0.6, stability_waves=99,
                  revote_debounce=60.0)
        sid = a.mgr.open_session(header)["sid"]
        first = a.mgr.receive_wave(sid, bodies[0])["status"]
        rej = _err(a.mgr.receive_wave, sid, bodies[1],
                   declared_sha="sha256:" + "0" * 64)
        ack = a.mgr.receive_wave(sid, bodies[1],
                                 declared_sha=_sha(bodies[1]))["status"]
        view = a.runner.journal.read_state().sessions[sid]
        disjoint = set(view["rejected"]).isdisjoint(set(view["waves"]))
        expected = sum(a.mod._count_reads(b) for b in bodies)
        a.close()
        b = _Side(tag, root, worker="w1", ttl=0.6, stability_waves=99)
        try:
            assert _adopt(b, sid), "thief never adopted"
            st = b.mgr.status(sid)
            aud = b.runner.journal.audit(full=True)["sessions"][sid]
            return [first, rej, ack, disjoint, st["absorbed"],
                    st["reads_total"] == expected, aud["lost_waves"],
                    aud["duplicated_waves"], aud["rejected_waves"] != [],
                    b.mgr.sessions[sid].wave_next > max(
                        int(w) for w in view["rejected"])]
        finally:
            b.close()

    t, r = run("t"), run("r")
    assert t == r
    assert t == ["pending", ("error", 422, "sha_mismatch", False),
                 "pending", True, 2, True, [], [], True, True]


# -- the serve CLI -------------------------------------------------------------
SESSION_ARGV = [
    ["--ingest-port", "0"],
    ["--ingest-port", "0", "--journal", "{j}", "-i", "x.sam"],
    ["--ingest-port", "0", "--journal", "{j}", "--batch", "4"],
    ["--ingest-port", "0", "--journal", "{j}", "--incremental"],
    ["--ingest-port", "0", "--journal", "{j}", "--count-cache", "64M"],
    ["--ingest-port", "0", "--journal", "{j}", "--stability-waves", "0"],
    ["--ingest-port", "0", "--journal", "{j}", "--revote-debounce", "-1"],
    ["--ingest-port", "0", "--journal", "{j}", "--ingest-max-body", "0"],
    ["--ingest-port", "0", "--journal", "{j}", "--ingest-timeout", "0"],
    ["--ingest-port", "0", "--journal", "{j}", "--ingest-max-pending",
     "0"],
    [],
]


@pytest.mark.parametrize("argv", SESSION_ARGV,
                         ids=[" ".join(a) or "none" for a in SESSION_ARGV])
def test_session_flag_cross_checks_equal_reference(tmp_path, argv):
    from sam2consensus_torch import cli as t_cli
    from sam2consensus_tpu import cli as r_cli

    argv = ["serve", *(a.replace("{j}", str(tmp_path / "j"))
                       for a in argv)]
    codes = []
    for main in (lambda: t_cli.main(argv, device="cpu"),
                 lambda: r_cli.main(argv)):
        with pytest.raises(SystemExit) as exc:
            main()
        codes.append(str(exc.value.code))
    assert codes[0] == codes[1]
    assert codes[0].startswith("error: ")
