"""The port's Poplar training journal against the reference's, on the CPU.

* Records are byte for byte the reference's (bfloat16 included, which the
  port writes from a torch tensor and the reference from an ``ml_dtypes``
  array), and ``flatten_state`` names leaves as ``jax.tree_util.keystr``.
* The reference's journal tests (``tests/test_journal.py``) run against
  both packages: async save, marker commit semantics, crash fallback,
  elastic resharding, torn lanes, incremental restores, columnar = scan.
* A journal written by either package restores under the other, columnar
  and scan, to the same step, arrays and metadata.
* Training (reduced tinyllama, hymba and rwkv6): a run crashed after a
  save, restored and resumed gives an uninterrupted run's losses exactly;
  the reference's state after k steps, restored by the port, takes one step
  equal to the reference's next one (1e-4, float32: summation order only);
  the hybrid's and rwkv's bfloat16 model trees (float32 leaves and the
  bfloat16 ``conv_w`` among them) with their AdamW moments, journaled by
  either package, restore under the other bit for bit; the train CLI
  resumes at the committed step with the journaled data cursor.
"""

import os
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.journal as jjournal
import repro_torch.journal as tjournal
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.core import Txn as JTxn
from repro.core import decode_columnar as jdecode_columnar
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.journal import records as jrecords
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core import Txn as TTxn
from repro_torch.core import decode_columnar as tdecode_columnar
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.journal import records as trecords
from repro_torch.launch import train as train_cli
from repro_torch.models.api import build_model
from repro_torch.models.weights import load_reference, to_reference
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step
from repro_torch.tree import keystr_items, tree_leaves, tree_map

PKGS = {
    "repro": types.SimpleNamespace(j=jjournal, records=jrecords, Txn=JTxn,
                                   decode_columnar=jdecode_columnar),
    "repro_torch": types.SimpleNamespace(j=tjournal, records=trecords, Txn=TTxn,
                                         decode_columnar=tdecode_columnar),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _state(step: int):
    return {
        "params": {
            "w": np.full((8, 4), float(step), np.float32),
            "b": np.arange(4, dtype=np.float32) + step,
        },
        "opt": {"mu": np.full((8, 4), 0.1 * step, np.float32)},
        "step": np.asarray(step),
    }


# --- records and keys --------------------------------------------------------------

def test_records_are_byte_identical():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 5)).astype(np.float32),
              rng.integers(-9, 9, (4,)).astype(np.int32),
              rng.integers(-9, 9, (2, 2, 3)).astype(np.int64),
              np.asarray(7), np.asarray(2.5, np.float32)]
    for a in arrays:
        want = jrecords.encode_array(a)
        assert trecords.encode_array(torch.from_numpy(a)) == want
        got = trecords.decode_array(want)
        assert got.dtype == torch.from_numpy(a).dtype and tuple(got.shape) == a.shape
        np.testing.assert_array_equal(got.numpy(), a)
    # bfloat16: the reference's ml_dtypes array and the port's tensor, bit for bit
    x = rng.standard_normal((6, 3)).astype(np.float32)
    ref = x.astype(ml_dtypes.bfloat16)
    tensor = torch.from_numpy(x).to(torch.bfloat16)
    want = jrecords.encode_array(ref)
    assert trecords.encode_array(tensor) == want
    got = trecords.decode_array(want)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16))
    back = jrecords.decode_array(trecords.encode_array(tensor))
    np.testing.assert_array_equal(back.view(np.int16), ref.view(np.int16))
    view = trecords.decode_array(want, copy=False)
    assert torch.equal(view, got)


def test_slices_split_as_numpy_does():
    for n, k in ((6, 4), (22, 22), (23, 4), (3, 4), (2048, 22)):
        arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        want = jrecords.split_slices(arr, k)
        got = trecords.split_slices(torch.from_numpy(arr), k)
        assert [p.shape[0] for p in got] == [p.shape[0] for p in want]
        np.testing.assert_array_equal(trecords.join_slices(got).numpy(), arr)
    assert trecords.parse_key(jrecords.shard_key(3, "['params']['w']", 1, 4)) == \
        jrecords.parse_key("0000000000000003/['params']['w']#1/4")


def test_flatten_state_keys_are_keystr():
    state = {"params": {"w": np.ones((2, 3), np.float32), "groups": [
                 {"attn": {"wq": np.zeros((2, 4), np.float32)}, "b": np.ones(2, np.float32)}]},
             "opt": {"mu": (np.ones(3, np.float32), np.zeros(1, np.int32)), "count": np.asarray(4)},
             "data": {"cursor": np.asarray(9, np.int64)}, "n": 3, "lr": 0.5}
    want = jjournal.flatten_state(state)
    got = tjournal.flatten_state(state)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert trecords.encode_array(g) == jrecords.encode_array(w)
    tensors = tree_map(lambda a: torch.from_numpy(np.array(a)), state)
    assert [k for k, _ in tjournal.flatten_state(tensors)] == [k for k, _ in want]
    with pytest.raises(TypeError):
        tjournal.flatten_state({"bad": "a string"})


# --- the reference's journal cases, on both packages ---------------------------------

def test_save_restore_roundtrip(pkg, tmp_path):
    mgr = pkg.j.PoplarCheckpointManager(str(tmp_path), n_lanes=3, device_kind="ssd",
                                        flush_interval=1e-3)
    for step in range(3):
        mgr.save(step, _state(step)).wait()
    mgr.wait_for_commit(2, timeout=30)
    mgr.close()
    step, st, meta = pkg.j.restore_latest(str(tmp_path))
    assert step == 2 and meta["step"] == 2
    tree = pkg.j.to_pytree(st, _state(0))
    np.testing.assert_array_equal(_np(tree["params"]["w"]), _state(2)["params"]["w"])
    np.testing.assert_array_equal(_np(tree["step"]), np.asarray(2))


def test_crash_falls_back_to_committed_step(pkg, tmp_path):
    mgr = pkg.j.PoplarCheckpointManager(str(tmp_path), n_lanes=2, device_kind="ssd",
                                        flush_interval=1e-3)
    mgr.save(0, _state(0)).wait()
    mgr.save(1, _state(1)).wait()
    mgr.wait_for_commit(1, timeout=30)
    h = mgr.save(2, _state(2))
    h.wait()          # logged (in volatile buffers), not necessarily durable
    mgr.crash()       # no quiesce, no flush
    step, st, _ = pkg.j.restore_latest(str(tmp_path))
    assert 1 <= step <= 2
    tree = pkg.j.to_pytree(st, _state(0))
    np.testing.assert_array_equal(_np(tree["params"]["w"]), _state(step)["params"]["w"])


def test_elastic_resharding(pkg, tmp_path):
    mgr = pkg.j.PoplarCheckpointManager(str(tmp_path), n_lanes=4, device_kind="ssd",
                                        flush_interval=1e-3, n_slices=4)
    big = {"w": np.arange(64, dtype=np.float32).reshape(16, 4)}
    mgr.save(0, big).wait()
    mgr.wait_for_commit(0, timeout=30)
    mgr.close()
    step, st, _ = pkg.j.restore_latest(str(tmp_path))
    np.testing.assert_array_equal(_np(st["['w']"]), big["w"])
    step2, st2, _ = pkg.j.restore_latest(str(tmp_path), parallel=False)
    assert step2 == step
    np.testing.assert_array_equal(_np(st2["['w']"]), _np(st["['w']"]))


def test_torn_lane_tail(pkg, tmp_path):
    mgr = pkg.j.PoplarCheckpointManager(str(tmp_path), n_lanes=2, device_kind="ssd",
                                        flush_interval=1e-3)
    for step in range(3):
        mgr.save(step, _state(step)).wait()
    mgr.wait_for_commit(2, timeout=30)
    mgr.close()
    with open(os.path.join(str(tmp_path), "log_0.bin"), "r+b") as f:
        f.seek(-5, os.SEEK_END)
        f.truncate()
    step, st, _ = pkg.j.restore_latest(str(tmp_path))
    tree = pkg.j.to_pytree(st, _state(0))
    np.testing.assert_array_equal(_np(tree["params"]["w"]), _state(step)["params"]["w"])


def test_marker_blocks_on_lagging_lane(pkg, tmp_path):
    mgr = pkg.j.PoplarCheckpointManager(str(tmp_path), n_lanes=2, device_kind="ssd",
                                        flush_interval=3600.0)
    try:
        mgr.save(0, _state(0)).wait()
        assert mgr.last_committed_step() == -1
        mgr.engine.buffers[0].force_establish()
        mgr.engine.buffers[0].flush_ready(mgr.engine.devices[0])
        mgr.engine.commit.advance_csn()
        assert mgr.last_committed_step() == -1
        for _ in range(3):
            for i in range(2):
                mgr.engine.logger_tick(i, force=True)
        assert mgr.last_committed_step() == 0
    finally:
        mgr.close()


def test_incremental_restore_with_tails(pkg, tmp_path):
    mgr = pkg.j.PoplarCheckpointManager(str(tmp_path), n_lanes=2, device_kind="ssd",
                                        flush_interval=1e-3)
    tails = pkg.j.JournalTails()
    for step in range(3):
        mgr.save(step, _state(step)).wait()
        mgr.wait_for_commit(step, timeout=30)
        inc = pkg.j.restore_latest(str(tmp_path), tails=tails)
        full = pkg.j.restore_latest(str(tmp_path))
        assert inc[0] == full[0] == step and inc[2] == full[2]
        assert inc[1].keys() == full[1].keys()
        for k in inc[1]:
            np.testing.assert_array_equal(_np(inc[1][k]), _np(full[1][k]))
    mgr.close()
    for path, sh in tails._shippers.items():
        with open(path, "rb") as f:
            assert sh.n_shipped == pkg.decode_columnar(f.read()).n_records
        assert sh.consumed == os.path.getsize(path)


def test_journal_tails_concurrent_probes(pkg, tmp_path):
    import threading

    path = os.path.join(str(tmp_path), "log_0.bin")
    tails = pkg.j.JournalTails()

    def writer():
        for i in range(50):
            t = pkg.Txn(tid=i, write_set=[(f"k{i}", b"v" * (i % 7))])
            t.ssn = i + 1
            with open(path, "ab") as f:
                f.write(t.encode())

    open(path, "wb").close()
    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=lambda: [tails.lane(path) for _ in range(40)]) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    final = tails.lane(path)
    with open(path, "rb") as f:
        blob = f.read()
    assert final.n_records == pkg.decode_columnar(blob).n_records == 50
    sh = tails._shippers[path]
    assert sh.consumed == len(blob) and sh.n_shipped == 50


def test_columnar_restore_matches_scan_oracle(pkg, tmp_path):
    mgr = pkg.j.PoplarCheckpointManager(str(tmp_path), n_lanes=3, device_kind="ssd",
                                        flush_interval=1e-3, n_slices=2)
    for step in range(4):
        mgr.save(step, _state(step)).wait()
    mgr.wait_for_commit(3, timeout=30)
    mgr.close()
    with open(os.path.join(str(tmp_path), "log_1.bin"), "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.truncate()
    step_c, st_c, meta_c = pkg.j.restore_latest(str(tmp_path), columnar=True)
    step_s, st_s, meta_s = pkg.j.restore_latest(str(tmp_path), columnar=False)
    assert step_c == step_s and meta_c == meta_s
    assert st_c.keys() == st_s.keys()
    for k in st_c:
        np.testing.assert_array_equal(_np(st_c[k]), _np(st_s[k]))


# --- across the packages ---------------------------------------------------------------

def _mixed_state(step: int, bf16):
    rng = np.random.default_rng(step)
    w = rng.standard_normal((9, 4)).astype(np.float32)
    return {"params": {"w": w, "e": bf16(rng.standard_normal((5, 3)).astype(np.float32)),
                       "groups": [{"k": rng.standard_normal((2, 4)).astype(np.float32)}]},
            "opt": {"count": np.asarray(step, np.int32)}, "data": {"cursor": np.asarray(step)}}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_cross_restore(writer, tmp_path):
    """A journal written by one package restores under the other, columnar
    and scan: the same step, metadata and arrays (bfloat16 bit for bit)."""
    reader = "repro" if writer == "repro_torch" else "repro_torch"
    bf16 = {"repro": lambda a: a.astype(ml_dtypes.bfloat16),
            "repro_torch": lambda a: torch.from_numpy(a).to(torch.bfloat16)}[writer]
    mgr = PKGS[writer].j.PoplarCheckpointManager(str(tmp_path), n_lanes=3, device_kind="ssd",
                                                 flush_interval=1e-3, n_slices=2)
    for step in range(3):
        mgr.save(step, _mixed_state(step, bf16), {"loss": 1.5 * step}).wait()
    mgr.wait_for_commit(2, timeout=30)
    mgr.close()
    want = PKGS[writer].j.restore_latest(str(tmp_path))
    for columnar in (True, False):
        got = PKGS[reader].j.restore_latest(str(tmp_path), columnar=columnar)
        assert got[0] == want[0] == 2 and got[2] == want[2] == {"loss": 3.0, "step": 2}
        assert sorted(got[1]) == sorted(want[1])
        for key in want[1]:
            assert PKGS[reader].records.encode_array(got[1][key]) == \
                PKGS[writer].records.encode_array(want[1][key]), key


# --- training through the journal -------------------------------------------------------

TRAIN_ARCHS = ["tinyllama-1.1b", "hymba-1.5b", "rwkv6-7b"]
DATA = DataConfig(vocab=reduced(get_config("tinyllama-1.1b")).vocab, batch=2, seq_len=32)
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def _fresh(arch, seed=0, dtype=torch.float32):
    model = build_model(reduced(get_config(arch)), device="cpu", dtype=dtype)
    model.init(torch.Generator().manual_seed(seed))
    params = to_reference(model)
    return model, params, adamw.init(params, OPT)


def _train(step_fn, params, opt, pipe, n, mgr=None, save_at=()):
    losses = []
    for step in n:
        batch = {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if step in save_at:
            mgr.save(step, {"params": params, "opt": opt, "data": pipe.state()},
                     {"loss": losses[-1]}).wait()
    return params, opt, losses


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_crash_restore_resume_is_exact(arch, tmp_path):
    """Run A trains 6 steps, saves at step 1 (committed) and step 3, crashes
    right after the second save and keeps training in memory; the resumed
    run restores the newest committed step into a fresh model and trains to
    step 5 with losses and final state equal to run A's exactly."""
    model, params, opt = _fresh(arch)
    step_fn = make_train_step(model, OPT)
    mgr = tjournal.PoplarCheckpointManager(str(tmp_path), n_lanes=2, n_slices=2,
                                           flush_interval=1e-3)
    pipe = TokenPipeline(DATA)
    params, opt, losses = _train(step_fn, params, opt, pipe, range(2), mgr, save_at=(1,))
    mgr.wait_for_commit(1, timeout=30)
    params, opt, more = _train(step_fn, params, opt, pipe, range(2, 4), mgr, save_at=(3,))
    mgr.crash()
    torn = TTxn(tid=99, write_set=[("torn", b"x" * 64)])
    torn.ssn = 1 << 40
    with open(os.path.join(str(tmp_path), "log_0.bin"), "ab") as f:
        f.write(torn.encode()[:40])
    params_a, opt_a, tail = _train(step_fn, params, opt, pipe, range(4, 6))
    losses_a = losses + more + tail

    step, flat, meta = tjournal.restore_latest(str(tmp_path))
    assert step in (1, 3) and meta["loss"] == losses_a[step]
    model_b, like_params, like_opt = _fresh(arch, seed=1)
    tree = tjournal.to_pytree(flat, {"params": like_params, "opt": like_opt,
                                     "data": TokenPipeline(DATA).state()})
    load_reference(model_b, tree["params"])
    params_b = to_reference(model_b)
    pipe_b = TokenPipeline.restore(DATA, {k: v.numpy() for k, v in tree["data"].items()})
    assert pipe_b.cursor == step + 1
    params_b, opt_b, losses_b = _train(make_train_step(model_b, OPT), params_b, tree["opt"],
                                       pipe_b, range(step + 1, 6))
    assert losses_b == losses_a[step + 1:]
    for a, b in zip(tree_leaves({"p": params_a, "o": opt_a}), tree_leaves({"p": params_b, "o": opt_b})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_reference_state_continues_under_the_port(arch, tmp_path):
    """The reference trains 2 steps and journals its state; the port
    restores it and takes step 2, equal to the reference's step 2 at 1e-4."""
    jcfg = jreduced(jget_config(arch))
    jmodel = jbuild_model(jcfg)
    jopt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    state = jadamw.init(params, jopt)
    jstep = jax.jit(jmake_train_step(jmodel, jopt))
    pipe = JTokenPipeline(JDataConfig(vocab=DATA.vocab, batch=2, seq_len=32))
    mgr = jjournal.PoplarCheckpointManager(str(tmp_path), n_lanes=2, flush_interval=1e-3)
    for step in range(2):
        params, state, _ = jstep(params, state, pipe.next_batch())
        mgr.save(step, {"params": params, "opt": state, "data": pipe.state()}).wait()
    mgr.wait_for_commit(1, timeout=30)
    mgr.close()
    batch = pipe.next_batch()
    want_p, _, want_m = jstep(params, state, batch)

    step, flat, _ = tjournal.restore_latest(str(tmp_path))
    assert step == 1
    model, like_p, like_o = _fresh(arch)
    tree = tjournal.to_pytree(flat, {"params": like_p, "opt": like_o,
                                     "data": TokenPipeline(DATA).state()})
    got_p, _, got_m = make_train_step(model, OPT)(
        tree["params"], tree["opt"], {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-4)
    for key, leaf in keystr_items(got_p):
        want = np.asarray(dict(keystr_items(want_p))[key])
        np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=key)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_model_state_cross_restores(arch, writer, tmp_path):
    """The bfloat16 model tree of a reduced hybrid or rwkv model (hymba's
    float32 ``a_log``, ``dt_bias``, ``d_skip`` and bfloat16 ``conv_w``;
    rwkv's ``time`` and ``channel`` subtrees) with its float32 AdamW moments,
    journaled by one package, restores under the other, columnar and scan,
    with every leaf's record byte for byte the writer's."""
    if writer == "repro":
        jmodel = jbuild_model(jreduced(jget_config(arch)))
        params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
        jopt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
        state = {"params": params, "opt": jax.tree.map(np.asarray, jadamw.init(params, jopt))}
    else:
        _, params, opt = _fresh(arch, dtype=torch.bfloat16)
        state = {"params": params, "opt": opt}
    dtypes = {str(a.dtype).replace("torch.", "") for a in tree_leaves(state["params"])}
    assert dtypes == {"bfloat16", "float32"}, dtypes
    mgr = PKGS[writer].j.PoplarCheckpointManager(str(tmp_path), n_lanes=2, n_slices=2,
                                                 flush_interval=1e-3)
    mgr.save(0, state, {"loss": 1.0}).wait()
    mgr.wait_for_commit(0, timeout=30)
    mgr.close()
    want = PKGS[writer].j.restore_latest(str(tmp_path))
    reader = "repro" if writer == "repro_torch" else "repro_torch"
    for columnar in (True, False):
        got = PKGS[reader].j.restore_latest(str(tmp_path), columnar=columnar)
        assert got[0] == want[0] == 0 and sorted(got[1]) == sorted(want[1])
        assert any("conv_w" in k for k in got[1]) or arch == "rwkv6-7b"
        assert any("['time']" in k for k in got[1]) or arch == "hymba-1.5b"
        for key in want[1]:
            assert PKGS[reader].records.encode_array(got[1][key]) == \
                PKGS[writer].records.encode_array(want[1][key]), key


def test_train_cli_runs_the_hybrid_reduced_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --arch hymba-1.5b --device cpu --reduced`` trains
    two steps, journals them and commits the last."""
    assert train_cli.main(["--arch", "hymba-1.5b", "--device", "cpu", "--reduced", "--steps", "2",
                           "--batch", "2", "--seq", "32", "--save-every", "1", "--log-every", "1",
                           "--journal-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "arch=hymba-1.5b" in out and "device=cpu" in out and "step     1" in out
    assert "[journal] last committed step: 1" in out


def test_train_cli_resumes_at_the_committed_step(tmp_path, capsys):
    args = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "32", "--save-every", "2",
            "--journal-dir", str(tmp_path), "--journal-lanes", "2", "--log-every", "1"]
    assert train_cli.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[journal] last committed step: 2" in out and "device=cpu" in out
    assert train_cli.main(args + ["--steps", "5"]) == 0
    out = capsys.readouterr().out
    assert "[restore] resumed from journaled step 2 (cursor=3" in out
    assert "steps 3..5" in out and "step     4" in out
    assert "[journal] last committed step: 4" in out
