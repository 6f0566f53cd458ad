"""The port's checkpoints (``fedtorch_tpu_torch/utils/checkpoint.py``)
against the JAX package's readers and the JAX package's own checkpoint
tests (``test_checkpoint_lifecycle.py``, ``test_fault_injection.py``
``TestCheckpointCrashSafety``, ``test_host_chaos.py``
``TestResumeFallback``), on the CPU.

* The JAX package's ``_unframe_payload``, ``frame_quick_ok`` and
  ``collect_round_keeps`` accept the port's files and keeps (the frame is
  the same bytes).
* Resume is bitwise — server params, optimizer state, round, generator
  state and every client tensor equal (sha256 of the bytes, tolerance 0)
  — on the device plane and on the stream plane: save at round r,
  resume into a fresh state, run to R, against an uninterrupted run.
* An async save is not changed by the in-place round that follows it:
  the write is held until after the next round rewrote the client state,
  and the file must hold the pre-round state (it would hold the
  post-round one if the snapshot aliased live memory).
* Corrupt, torn and bit-flipped files are skipped by name; a missing
  meta file, an incompatible config and a JAX payload raise.
"""
import json
import os
import threading
import warnings

import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.utils import checkpoint as jck
from fedtorch_tpu_torch.utils import checkpoint as tck
from torch_lifecycle import (
    file_digest, load_payload, make_trainer, state_digest,
)


def _run(trainer, server, clients, n):
    for _ in range(n):
        server, clients, _ = trainer.run_round(server, clients)
    return server, clients


def _saved(tmp_path, rounds=1, is_best=False, **kw):
    t = make_trainer()
    s, c = _run(t, *t.init_state(0), rounds)
    d = str(tmp_path)
    tck.save_checkpoint(d, s, c, t.cfg, best_prec1=0.5, is_best=is_best,
                        **kw)
    return t, s, c, d


# -- the frame and the keeps, read by the JAX package ------------------------
def test_the_jax_package_unframes_the_port_s_files(tmp_path):
    t, s, c, d = _saved(tmp_path)
    blob = open(os.path.join(d, "checkpoint.ckpt"), "rb").read()
    assert blob.startswith(jck._CKPT_MAGIC)
    payload, why = jck._unframe_payload(blob)
    assert why is None and payload == tck._unframe_payload(blob)[0]
    assert jck.frame_quick_ok(os.path.join(d, "checkpoint.ckpt"))
    # a torn copy: both packages name it torn
    torn = os.path.join(d, "torn.ckpt")
    with open(torn, "wb") as f:
        f.write(blob[:len(blob) // 2])
    assert not jck.frame_quick_ok(torn) and not tck.frame_quick_ok(torn)
    assert jck._unframe_payload(blob[:-1])[1] == \
        tck._unframe_payload(blob[:-1])[1]


@pytest.mark.parametrize("collect", ["jax", "port"])
def test_keep_retention_on_the_port_s_keeps(collect, tmp_path):
    t = make_trainer(ckpt={"keep_last_n": 0})
    s, c = t.init_state(0)
    d = str(tmp_path)
    for _ in range(5):
        s, c, _ = t.run_round(s, c)
        tck.save_checkpoint(d, s, c, t.cfg, 0.0, is_best=False,
                            save_all=True)
    # a torn newest keep never counts against the budget
    newest = os.path.join(d, "checkpoint_r5.ckpt")
    blob = open(newest, "rb").read()
    with open(newest, "wb") as f:
        f.write(blob[:100])
    fn = jck.collect_round_keeps if collect == "jax" \
        else tck.collect_round_keeps
    removed = sorted(os.path.basename(p) for p in fn(d, 2))
    assert removed == ["checkpoint_r1.ckpt", "checkpoint_r2.ckpt",
                       "checkpoint_r5.ckpt"]
    assert sorted(f for f in os.listdir(d) if f.startswith("checkpoint_r")) \
        == ["checkpoint_r3.ckpt", "checkpoint_r4.ckpt"]


def test_keep_last_n_gc_at_save_and_model_best_never_collected(tmp_path):
    t = make_trainer(ckpt={"keep_last_n": 2})
    s, c = t.init_state(0)
    d = str(tmp_path)
    for r in range(4):
        s, c, _ = t.run_round(s, c)
        tck.save_checkpoint(d, s, c, t.cfg, 0.1 * r, is_best=r == 0,
                            save_all=True)
    assert sorted(f for f in os.listdir(d) if f.endswith(".ckpt")) == [
        "checkpoint.ckpt", "checkpoint_r3.ckpt", "checkpoint_r4.ckpt",
        "model_best.ckpt"]
    assert json.load(open(os.path.join(d, "checkpoint.json")))["round"] == 4


def test_run_dir_used_exactly_and_default_layout(tmp_path):
    t = make_trainer(ckpt={"run_dir": str(tmp_path / "pinned")})
    assert tck.init_checkpoint_dir(t.cfg) == str(tmp_path / "pinned")
    t2 = make_trainer(ckpt={"checkpoint_dir": str(tmp_path / "ck")})
    d = tck.init_checkpoint_dir(t2.cfg)
    assert d.startswith(str(tmp_path / "ck" / "synthetic"
                            / "logistic_regression"))
    assert "alg-fedavg" in d and os.path.isdir(d)


# -- resume --------------------------------------------------------------
def test_valid_checkpoint_resumes_every_leaf_bitwise(tmp_path):
    t, s, c, d = _saved(tmp_path, rounds=2)
    s0, c0 = t.init_state(9)
    s2, c2, best, resumed = tck.maybe_resume(d, s0, c0, t.cfg)
    assert resumed and best == 0.5 and s2.round == 2
    assert state_digest(s2, c2) == state_digest(s, c)
    assert file_digest(os.path.join(d, "checkpoint.ckpt"), True) \
        == state_digest(s, c)


@pytest.mark.parametrize("plane", ["device", "stream"])
def test_resume_continues_bitwise(plane, tmp_path):
    """Save at round 2, resume into a fresh state, run to round 4:
    equal (tolerance 0) to 4 uninterrupted rounds, generator included."""
    ref = make_trainer(plane=plane)
    try:
        s, c = _run(ref, *ref.init_state(0), 4)
        want = state_digest(s, c)
    finally:
        ref.close()
    a = make_trainer(plane=plane)
    try:
        s, c = _run(a, *a.init_state(0), 2)
        tck.save_checkpoint(str(tmp_path), s, c, a.cfg, 0.0, False)
    finally:
        a.close()
    b = make_trainer(plane=plane)
    try:
        s, c, _, resumed = tck.maybe_resume(str(tmp_path), *b.init_state(5),
                                            b.cfg)
        b.invalidate_stream()
        assert resumed and s.round == 2
        s, c = _run(b, s, c, 2)
        assert state_digest(s, c) == want
    finally:
        b.close()


def test_indexed_checkpoint_resumes_with_integrity(tmp_path):
    t = make_trainer()
    s, c = t.init_state(0)
    d = str(tmp_path)
    s, c, _ = t.run_round(s, c)
    want = state_digest(s, c)
    tck.save_checkpoint(d, s, c, t.cfg, 0.1, False, save_some_rounds=(1,))
    s, c, _ = t.run_round(s, c)
    tck.save_checkpoint(d, s, c, t.cfg, 0.2, False)  # a newer latest
    s2, c2, _, resumed = tck.maybe_resume(d, *t.init_state(9), t.cfg,
                                          checkpoint_index="1")
    assert resumed and s2.round == 1 and state_digest(s2, c2) == want


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_damaged_checkpoint_skipped(damage, tmp_path):
    t, s, c, d = _saved(tmp_path)
    path = os.path.join(d, "checkpoint.ckpt")
    blob = bytearray(open(path, "rb").read())
    if damage == "truncate":
        blob = blob[:len(blob) // 2]
    else:
        blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    s0, c0 = t.init_state(9)
    fresh = state_digest(s0, c0)
    with pytest.warns(RuntimeWarning, match="corrupt or truncated"):
        s2, c2, best, resumed = tck.maybe_resume(d, s0, c0, t.cfg)
    assert not resumed and best == 0.0
    assert state_digest(s2, c2) == fresh  # nothing half-grafted


def test_missing_meta_and_incompatible_config_raise(tmp_path):
    t, s, c, d = _saved(tmp_path)
    t2 = make_trainer(num_clients=4)
    with pytest.raises(ValueError, match="incompatible"):
        tck.maybe_resume(d, *t2.init_state(9), t2.cfg)
    os.remove(os.path.join(d, "checkpoint.json"))
    with pytest.raises(FileNotFoundError):
        tck.maybe_resume(d, *t.init_state(9), t.cfg)
    with pytest.raises(FileNotFoundError):
        tck.maybe_resume(str(tmp_path / "nothing"), *t.init_state(9), t.cfg)


def test_a_jax_payload_is_refused_by_name(tmp_path):
    """The JAX package's checkpoint (flax msgpack, threefry key) beside
    compatible meta: the port refuses it by name, it does not load it
    and go on with other draws."""
    from flax import serialization
    t, s, c, d = _saved(tmp_path)
    payload = serialization.msgpack_serialize(
        {"server": {"round": 1, "rng": [0, 7]}, "clients": {}})
    with open(os.path.join(d, "checkpoint.ckpt"), "wb") as f:
        f.write(jck._frame_payload(payload))
    with pytest.raises(tck.ForeignCheckpointError, match="JAX package"):
        tck.maybe_resume(d, *t.init_state(9), t.cfg)


def test_corrupt_meta_falls_back_to_model_best_json(tmp_path):
    t, s, c, d = _saved(tmp_path, is_best=True)
    with open(os.path.join(d, "checkpoint.json"), "w") as f:
        f.write("{torn")
    with pytest.warns(RuntimeWarning, match="model_best.json"):
        s2, c2, _, resumed = tck.maybe_resume(d, *t.init_state(9), t.cfg)
    assert resumed and state_digest(s2, c2) == state_digest(s, c)


def test_torn_latest_falls_back_to_newest_valid_keep_naming_skips(tmp_path):
    t = make_trainer()
    s, c = t.init_state(0)
    d = str(tmp_path)
    digests = {}
    for r in range(1, 4):
        s, c, _ = t.run_round(s, c)
        digests[r] = state_digest(s, c)
        tck.save_checkpoint(d, s, c, t.cfg, 0.0, False, save_all=True)
    for name in ("checkpoint.ckpt", "checkpoint_r3.ckpt"):
        path = os.path.join(d, name)
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) - 10])
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        s2, c2, _, resumed = tck.maybe_resume(d, *t.init_state(9), t.cfg)
    msg = " ".join(str(w.message) for w in seen)
    assert resumed and s2.round == 2
    assert state_digest(s2, c2) == digests[2]
    assert "checkpoint.ckpt" in msg and "checkpoint_r3.ckpt" in msg \
        and "checkpoint_r2.ckpt" in msg


# -- the async writer ------------------------------------------------------
def test_async_save_is_not_changed_by_the_next_in_place_round(
        tmp_path, monkeypatch):
    t = make_trainer()
    s, c = _run(t, *t.init_state(0), 1)
    before = state_digest(s, c)
    gate = threading.Event()
    write = tck._write_checkpoint

    def held(*a, **kw):
        assert gate.wait(30)
        return write(*a, **kw)

    monkeypatch.setattr(tck, "_write_checkpoint", held)
    ck = tck.AsyncCheckpointer()
    try:
        ck.save(str(tmp_path), s, c, t.cfg, 0.0, False)
        # the next round rewrites the client rows in place
        s2, c2, _ = t.run_round(s, c)
        assert state_digest(s2, c2) != before
        gate.set()
        ck.wait()
    finally:
        gate.set()
        ck.close()
    assert file_digest(str(tmp_path / "checkpoint.ckpt"), True) == before
    assert ck.stats()["ckpt_writes"] == 1.0


def test_async_checkpointer_close_is_idempotent_and_unregisters(tmp_path):
    import atexit
    ck = tck.AsyncCheckpointer()
    t = make_trainer()
    s, c = t.init_state(0)
    ck.save(str(tmp_path), s, c, t.cfg, 0.0, False, save_all=True)
    ck.close()
    ck.close()
    assert not ck._thread.is_alive()
    assert os.path.exists(tmp_path / "checkpoint_r0.ckpt")
    # unregistered: a second unregister finds nothing and does not raise
    atexit.unregister(ck._atexit_close)


def test_payload_is_plain_host_tensors_and_ints(tmp_path):
    t, s, c, d = _saved(tmp_path)
    state = load_payload(os.path.join(d, "checkpoint.ckpt"))
    assert state["format"] == tck.PAYLOAD_FORMAT
    assert set(state["server"]) == {"params", "opt", "aux", "round",
                                    "rng_state"}
    assert set(state["clients"]) == {"params", "opt", "aux", "epoch",
                                     "local_index"}
    assert state["server"]["round"] == 1
    assert torch.equal(state["server"]["rng_state"], s.rng.get_state())
    assert all(v.device.type == "cpu"
               for v in state["clients"]["params"].values())
