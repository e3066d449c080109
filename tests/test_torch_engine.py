"""The write path's parts against the reference (tests/test_engine.py's
cases, run on both packages): the translog (round trip, reopen, a torn
tail truncated, corruption detected, generations rolled and trimmed),
the seqno trackers and retention leases, and the versioned engine
(realtime GET, versions, deletes, create conflicts, compare-and-set,
refresh, flush and recovery, the merge policy, force merge and the
near-real-time rule). Each case runs against ``elasticsearch_tpu`` and
``elasticsearch_tpu_torch`` with the same outcome; then each package
opens the other's translog and segment files."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from elasticsearch_tpu.common import errors as jax_errors
from elasticsearch_tpu.index import engine as jax_engine
from elasticsearch_tpu.index import segment as jax_segment
from elasticsearch_tpu.index import seqno as jax_seqno
from elasticsearch_tpu.index import translog as jax_translog
from elasticsearch_tpu.index.mapper import MapperService
from elasticsearch_tpu_torch.common import errors as port_errors
from elasticsearch_tpu_torch.index import engine as port_engine
from elasticsearch_tpu_torch.index import segment as port_segment
from elasticsearch_tpu_torch.index import seqno as port_seqno
from elasticsearch_tpu_torch.index import translog as port_translog
from elasticsearch_tpu_torch.index.mapper import DocumentMapper

MAPPINGS = {"properties": {"body": {"type": "text"}, "n": {"type": "long"}}}

PACKAGES = {
    "jax": SimpleNamespace(
        Engine=jax_engine.Engine, Translog=jax_translog.Translog,
        TranslogOp=jax_translog.TranslogOp,
        LocalCheckpointTracker=jax_seqno.LocalCheckpointTracker,
        ReplicationTracker=jax_seqno.ReplicationTracker,
        TranslogCorruptedException=jax_errors.TranslogCorruptedException,
        VersionConflictEngineException=(
            jax_errors.VersionConflictEngineException),
        mapper=lambda: MapperService(mappings=MAPPINGS)),
    "torch": SimpleNamespace(
        Engine=port_engine.Engine, Translog=port_translog.Translog,
        TranslogOp=port_translog.TranslogOp,
        LocalCheckpointTracker=port_seqno.LocalCheckpointTracker,
        ReplicationTracker=port_seqno.ReplicationTracker,
        TranslogCorruptedException=port_errors.TranslogCorruptedException,
        VersionConflictEngineException=(
            port_errors.VersionConflictEngineException),
        mapper=lambda: DocumentMapper(MAPPINGS)),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture
def engine(pkg, tmp_path):
    e = pkg.Engine(str(tmp_path / "shard0"), pkg.mapper())
    yield e
    e.close()


# --------------------------------------------------------------- translog

def test_translog_roundtrip(pkg, tmp_path):
    t = pkg.Translog(str(tmp_path / "tl"))
    t.add(pkg.TranslogOp("index", 0, 1, doc_id="a", source={"x": 1}))
    t.add(pkg.TranslogOp("delete", 1, 1, doc_id="a"))
    t.sync()
    ops = t.read_ops()
    assert [o.op_type for o in ops] == ["index", "delete"]
    assert ops[0].source == {"x": 1}
    t.close()


def test_translog_survives_reopen(pkg, tmp_path):
    p = str(tmp_path / "tl")
    t = pkg.Translog(p)
    t.add(pkg.TranslogOp("index", 0, 1, doc_id="a", source={}))
    t.sync()
    t.close()
    t2 = pkg.Translog(p)
    assert len(t2.read_ops()) == 1
    t2.add(pkg.TranslogOp("index", 1, 1, doc_id="b", source={}))
    assert len(t2.read_ops()) == 2
    t2.close()


def test_translog_ops_reach_the_file_as_they_are_added(tmp_path):
    """The port's ``add`` writes each op through to the operating system:
    a second reader of the directory finds every op while the writer is
    still open, with no ``sync`` or ``close`` between."""
    p = str(tmp_path / "tl")
    t = port_translog.Translog(p)
    for i in range(50):
        t.add(port_translog.TranslogOp("index", i, 1, doc_id=str(i),
                                       source={"n": i}))
    reader = port_translog.Translog(p)
    ops = reader.read_ops()
    assert [o.doc_id for o in ops] == [str(i) for i in range(50)]
    assert ops[-1].source == {"n": 49}
    reader.close()
    t.close()


def test_a_write_batch_reaches_the_file_at_its_end(tmp_path):
    """Inside ``write_batch`` (one ``_bulk`` request) the ops wait in the
    buffer; at its end every translog the batch reached has them in
    its file, as a second reader finds."""
    paths = [str(tmp_path / "tl0"), str(tmp_path / "tl1")]
    logs = [port_translog.Translog(p) for p in paths]
    with port_translog.write_batch():
        for i in range(10):
            logs[i % 2].add(port_translog.TranslogOp(
                "index", i, 1, doc_id=str(i), source={"n": i}))
        with port_translog.write_batch():       # nested: joins the outer
            logs[0].add(port_translog.TranslogOp("delete", 10, 1,
                                                 doc_id="0"))
    for j, p in enumerate(paths):
        reader = port_translog.Translog(p)
        assert [o.seq_no for o in reader.read_ops()] == (
            list(range(j, 10, 2)) + ([10] if j == 0 else []))
        reader.close()
    for log in logs:
        log.close()


_KILLED_WRITER = """
import os, signal, sys
from elasticsearch_tpu_torch.index.engine import Engine
from elasticsearch_tpu_torch.index.mapper import DocumentMapper
from elasticsearch_tpu_torch.index.translog import write_batch
e = Engine(sys.argv[1], DocumentMapper({"properties": {
    "body": {"type": "text"}, "n": {"type": "long"}}}))
e.index("0", {"body": "committed", "n": 0})
e.flush()
for i in range(1, 100):
    e.index(str(i), {"body": "acknowledged only", "n": i})
with write_batch():                     # a bulk request's ops
    for i in range(100, 200):
        e.index(str(i), {"body": "acknowledged only", "n": i})
e.delete("5")
print("acknowledged", flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_acknowledged_ops_survive_a_killed_process(tmp_path):
    """A process killed (no ``close``, no ``flush``) after its engine
    acknowledged writes: a new engine on the path replays every one."""
    import signal
    import subprocess
    import sys
    path = str(tmp_path / "shard0")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _KILLED_WRITER, path],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert proc.stdout.strip() == "acknowledged"
    e = port_engine.Engine(path, DocumentMapper(MAPPINGS))
    try:
        for i in range(200):
            got = e.get(str(i))
            assert got.found == (i != 5), i
            if i != 5:
                assert got.source["n"] == i
        assert e.get("199").seq_no == 199
        assert e.tracker.max_seq_no == 200
    finally:
        e.close()


def test_translog_torn_tail_truncated(pkg, tmp_path):
    p = str(tmp_path / "tl")
    t = pkg.Translog(p)
    t.add(pkg.TranslogOp("index", 0, 1, doc_id="a", source={}))
    t.sync()
    t.close()
    with open(os.path.join(p, "translog-1.log"), "ab") as fh:
        fh.write(b"\x50\x00\x00\x00partial")
    t2 = pkg.Translog(p)
    assert len(t2.read_ops()) == 1
    t2.close()


def test_translog_detects_corruption(pkg, tmp_path):
    p = str(tmp_path / "tl")
    t = pkg.Translog(p)
    t.add(pkg.TranslogOp("index", 0, 1, doc_id="a", source={"k": "v"}))
    t.sync()
    t.close()
    path = os.path.join(p, "translog-1.log")
    data = bytearray(open(path, "rb").read())
    data[10] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(pkg.TranslogCorruptedException):
        pkg.Translog(p)


def test_translog_generation_roll_and_trim(pkg, tmp_path):
    p = str(tmp_path / "tl")
    t = pkg.Translog(p)
    t.add(pkg.TranslogOp("index", 0, 1, doc_id="a", source={}))
    gen = t.roll_generation()
    t.add(pkg.TranslogOp("index", 1, 1, doc_id="b", source={}))
    assert len(t.read_ops()) == 2
    assert len(t.read_ops(from_generation=gen)) == 1
    t.trim_generations(gen)
    assert not os.path.exists(os.path.join(p, "translog-1.log"))
    t.close()


# ----------------------------------------------------------------- seqno

def test_local_checkpoint_contiguous(pkg):
    t = pkg.LocalCheckpointTracker()
    s0, s1, s2 = t.generate_seq_no(), t.generate_seq_no(), t.generate_seq_no()
    t.mark_seq_no_as_processed(s0)
    t.mark_seq_no_as_processed(s2)
    assert t.checkpoint == 0
    t.mark_seq_no_as_processed(s1)
    assert t.checkpoint == 2
    assert t.max_seq_no == 2


def test_replication_tracker_global_checkpoint(pkg):
    rt = pkg.ReplicationTracker("primary", local_checkpoint=5)
    assert rt.global_checkpoint == 5
    rt.init_tracking("replica1")
    rt.mark_in_sync("replica1", 3)
    assert rt.global_checkpoint == 5
    rt.update_local_checkpoint("replica1", 7)
    rt.update_local_checkpoint("primary", 9)
    assert rt.global_checkpoint == 7
    rt.remove_copy("replica1")
    assert rt.global_checkpoint == 9


def test_retention_leases(pkg):
    rt = pkg.ReplicationTracker("p", local_checkpoint=10)
    rt.add_retention_lease("peer_recovery/r1", 4, "peer recovery")
    assert rt.min_retained_seq_no() == 4
    rt.renew_retention_lease("peer_recovery/r1", 8)
    assert rt.min_retained_seq_no() == 8
    rt.remove_retention_lease("peer_recovery/r1")
    assert rt.min_retained_seq_no() == 11


# ---------------------------------------------------------------- engine

def test_index_get_realtime(engine):
    r = engine.index("1", {"body": "hello world", "n": 1})
    assert r.created and r.version == 1 and r.seq_no == 0
    g = engine.get("1")
    assert g.found and g.source == {"body": "hello world", "n": 1}


def test_update_increments_version(engine):
    engine.index("1", {"n": 1})
    r2 = engine.index("1", {"n": 2})
    assert not r2.created and r2.version == 2
    assert engine.get("1").source == {"n": 2}
    engine.refresh()
    assert engine.get("1").source == {"n": 2}
    assert engine.stats()["docs"]["count"] == 1


def test_update_after_refresh_tombstones_old(engine):
    engine.index("1", {"n": 1})
    engine.refresh()
    engine.index("1", {"n": 2})
    engine.refresh()
    assert engine.stats()["docs"]["count"] == 1
    assert engine.get("1").source == {"n": 2}
    snap = engine.acquire_searcher()
    assert sum(s.live_doc_count for s in snap.segments) == 1


def test_delete(engine):
    engine.index("1", {"n": 1})
    d = engine.delete("1")
    assert d.found and d.version == 2
    assert not engine.get("1").found
    assert not engine.delete("nope").found


def test_create_conflict(pkg, engine):
    engine.index("1", {"n": 1})
    with pytest.raises(pkg.VersionConflictEngineException):
        engine.index("1", {"n": 2}, op_type="create")


def test_cas_if_seq_no(pkg, engine):
    r = engine.index("1", {"n": 1})
    r2 = engine.index("1", {"n": 2}, if_seq_no=r.seq_no,
                      if_primary_term=r.primary_term)
    assert r2.version == 2
    with pytest.raises(pkg.VersionConflictEngineException):
        engine.index("1", {"n": 3}, if_seq_no=r.seq_no,
                     if_primary_term=r.primary_term)


def test_refresh_publishes_segment(engine):
    engine.index("1", {"body": "x"})
    snap0 = engine.acquire_searcher()
    assert snap0.doc_count == 0
    assert engine.refresh() is True
    snap1 = engine.acquire_searcher()
    assert snap1.doc_count == 1
    assert snap1.epoch > snap0.epoch
    assert engine.refresh() is False


def test_flush_and_recover(pkg, tmp_path):
    path = str(tmp_path / "shardX")
    e = pkg.Engine(path, pkg.mapper())
    e.index("1", {"body": "persisted doc", "n": 1})
    e.index("2", {"body": "second", "n": 2})
    e.flush()
    e.index("3", {"body": "only in translog", "n": 3})
    e.translog.sync()
    e.close()
    e2 = pkg.Engine(path, pkg.mapper())
    assert e2.get("1").found
    assert e2.get("3").found
    assert e2.get("3").source["n"] == 3
    e2.refresh()
    assert e2.stats()["docs"]["count"] == 3
    assert e2.tracker.max_seq_no == 2
    e2.close()


def test_recover_with_deletes(pkg, tmp_path):
    path = str(tmp_path / "shardY")
    e = pkg.Engine(path, pkg.mapper())
    e.index("1", {"n": 1})
    e.flush()
    e.delete("1")
    e.index("2", {"n": 2})
    e.translog.sync()
    e.close()
    e2 = pkg.Engine(path, pkg.mapper())
    assert not e2.get("1").found
    assert e2.get("2").found
    e2.close()


def test_merge_policy_bounds_segment_count(pkg, tmp_path):
    e = pkg.Engine(str(tmp_path / "shardM"), pkg.mapper(), merge_factor=3)
    for i in range(6):
        e.index(str(i), {"n": i})
        e.refresh()
    assert len(e.segments) <= 3
    assert e.stats()["docs"]["count"] == 6
    for i in range(6):
        assert e.get(str(i)).found
    e.close()


def test_force_merge(engine):
    for i in range(5):
        engine.index(str(i), {"n": i})
        engine.refresh()
    engine.force_merge(max_num_segments=1)
    assert len(engine.segments) == 1
    assert engine.stats()["docs"]["count"] == 5


def test_update_keeps_old_version_searchable_until_refresh(engine):
    engine.index("1", {"body": "original text"})
    engine.refresh()
    engine.index("1", {"body": "updated text"})
    snap = engine.acquire_searcher()
    assert snap.doc_count == 1
    assert all(s.live_doc_count == s.n_docs for s in snap.segments)
    assert engine.get("1").source == {"body": "updated text"}
    engine.refresh()
    assert engine.stats()["docs"]["count"] == 1


def test_delete_invisible_until_refresh(engine):
    engine.index("1", {"n": 1})
    engine.refresh()
    engine.delete("1")
    assert engine.acquire_searcher().doc_count == 1
    assert not engine.get("1").found
    engine.refresh()
    assert engine.acquire_searcher().doc_count == 0


# ------------------------------------------------- the two packages' files

OPS = [("index", "a", {"body": "red fox", "n": 1}),
       ("index", "b", {"body": "blue whale é", "n": 2}),
       ("delete", "a", None),
       ("index", "c", {"body": "green ☺", "n": [3, 4]})]


def _engine_ops(e):
    for op, doc_id, src in OPS:
        if op == "index":
            e.index(doc_id, src)
        else:
            e.delete(doc_id)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_translog_files_are_byte_equal_and_cross_read(writer, tmp_path):
    """The same ops give byte-equal translog and checkpoint files in both
    packages, and each package reads the other's."""
    dirs = {}
    for name, pkg in PACKAGES.items():
        dirs[name] = str(tmp_path / name)
        t = pkg.Translog(dirs[name])
        for seq, (op, doc_id, src) in enumerate(OPS):
            t.add(pkg.TranslogOp(op, seq, 1, doc_id=doc_id, source=src))
        t.sync()
        t.close()
    for f in ("translog-1.log", "translog.ckp"):
        assert open(os.path.join(dirs["jax"], f), "rb").read() == \
            open(os.path.join(dirs["torch"], f), "rb").read(), f
    reader = PACKAGES["torch" if writer == "jax" else "jax"]
    ops = reader.Translog(dirs[writer]).read_ops()
    assert [(o.op_type, o.seq_no, o.doc_id, o.source) for o in ops] == \
        [(op, seq, doc_id, src) for seq, (op, doc_id, src) in enumerate(OPS)]


def _segment_arrays(seg):
    """Every array and list a segment holds, by a name each package
    shares."""
    out = {"live": seg.live, "stored~offsets": seg.stored.offsets,
           "ids": seg.stored.ids, "data": seg.stored.data}
    for f, pf in seg.postings.items():
        for a in ("doc_freq", "total_term_freq", "term_block_start",
                  "term_block_count", "block_docids", "block_tfs",
                  "block_max_tf", "block_min_len", "field_lengths",
                  "terms", "sum_total_term_freq", "sum_doc_freq",
                  "doc_count"):
            out[f"p~{f}~{a}"] = getattr(pf, a)
    for f, nv in seg.numerics.items():
        for a in ("values", "missing", "offsets", "all_values"):
            out[f"n~{f}~{a}"] = getattr(nv, a)
    for f, kv in seg.keywords.items():
        for a in ("terms", "ords", "offsets", "all_ords"):
            out[f"k~{f}~{a}"] = getattr(kv, a)
    for f, vv in seg.vectors.items():
        for a in ("vectors", "has_value", "dims", "similarity"):
            out[f"v~{f}~{a}"] = getattr(vv, a)
    for f, ts in seg.streams.items():
        out[f"s~{f}"] = (ts.tokens, ts.lengths)
    for f, cv in seg.completions.items():
        out[f"c~{f}"] = (cv.inputs, cv.weights, cv.doc_of, cv.contexts)
    return out


def _assert_same(a, b, key=""):
    if isinstance(a, tuple):
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            _assert_same(x, y, key)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=key)
    else:
        assert a == b, key


RICH_MAPPINGS = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "n": {"type": "long"}, "vec": {"type": "dense_vector", "dims": 3},
    "sug": {"type": "completion"}}}


def _rich_docs():
    rng = np.random.default_rng(5)
    words = ["amber", "dune", "cedar", "fjord", "é", "mesa"]
    for i in range(40):
        d = {"body": " ".join(rng.choice(words, 4)),
             "tag": str(rng.choice(["x", "y", "z"])), "n": int(i % 7)}
        if i % 3:
            d["vec"] = rng.standard_normal(3).round(3).tolist()
        if i % 4 == 0:
            d["sug"] = {"input": [f"sug{i}"], "weight": i}
        yield str(i), d


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_segment_files_cross_open(writer, tmp_path):
    """A segment of every column kind (postings with block-max meta,
    numerics with the metadata columns, keywords, vectors, streams,
    completions, stored, deletes) saved by one package opens in the
    other with every array equal, and both packages write the same
    files from the same documents."""
    segs = {}
    for name, pkg in PACKAGES.items():
        mapper = (MapperService(mappings=RICH_MAPPINGS) if name == "jax"
                  else DocumentMapper(RICH_MAPPINGS))
        e = pkg.Engine(str(tmp_path / f"e-{name}"), mapper)
        for doc_id, d in _rich_docs():
            e.index(doc_id, d)
        e.refresh()
        for doc_id in ("3", "17"):
            e.delete(doc_id)
        e.refresh()
        segs[name] = e.segments[0]
        e.close()
    for name in PACKAGES:
        segs[name].save(str(tmp_path / f"seg-{name}"))
    with open(tmp_path / "seg-jax" / "stored.bin", "rb") as fh, \
            open(tmp_path / "seg-torch" / "stored.bin", "rb") as gh:
        assert fh.read() == gh.read()
    reader = port_segment.Segment if writer == "jax" \
        else jax_segment.Segment
    loaded = reader.load(str(tmp_path / f"seg-{writer}"))
    want = _segment_arrays(segs[writer])
    got = _segment_arrays(loaded)
    assert sorted(got) == sorted(want)
    for key in want:
        _assert_same(got[key], want[key], key)
    assert loaded.live_doc_count == 38
    assert "_seq_no" in loaded.numerics and "_version" in loaded.numerics


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_engine_directories_cross_recover(writer, tmp_path):
    """A shard directory (commit point, segments, translog) written by
    one package's engine recovers in the other's: the same documents,
    versions, seq_nos and stats, the next write continuing the
    sequence."""
    path = str(tmp_path / "shard")
    src_pkg = PACKAGES[writer]
    dst = "torch" if writer == "jax" else "jax"
    e = src_pkg.Engine(path, src_pkg.mapper())
    for i in range(6):
        e.index(str(i), {"body": f"doc {i}", "n": i})
    e.index("2", {"body": "doc two again", "n": 20})
    e.flush()
    e.delete("4")
    e.index("5", {"body": "five in the translog", "n": 50})
    e.index("6", {"body": "six", "n": 6})
    e.translog.sync()
    want = {str(i): e.get(str(i)) for i in range(8)}
    e.close()
    e2 = PACKAGES[dst].Engine(path, PACKAGES[dst].mapper())
    try:
        for doc_id, g in want.items():
            got = e2.get(doc_id)
            assert (got.found, got.source, got.version, got.seq_no,
                    got.primary_term) == (g.found, g.source, g.version,
                                          g.seq_no, g.primary_term), doc_id
        e2.refresh()
        assert e2.stats()["docs"]["count"] == 6
        assert e2.tracker.max_seq_no == 9
        r = e2.index("7", {"n": 7})
        assert (r.seq_no, r.version, r.created) == (10, 1, True)
    finally:
        e2.close()
