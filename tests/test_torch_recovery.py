"""The port's recovery against the reference's, exactly, on the same bytes.

Segmented, path-backed device logs are written once by each package's
framing (``Txn.encode`` + ``StorageDevice.write``/``seal``), then recovered
by both packages in every mode — the reference's ``scalar``/``vectorized``/
``pallas`` and the port's ``scalar``/``vectorized``/``kernel`` (on
``device="cpu"``, the plain versions).  Every ``RecoveredState`` must be
identical (data, rsns, rsne, replayed and skipped counts), and logs written
by either package recover under the other.  Torn tails, a corrupt frame in a
sealed segment, and a checkpoint image that must win its SSN ties are
included.
"""

import os
import random

import pytest

from repro.core import recover as jrecover
from repro.core.checkpoint import CheckpointDaemon as JCheckpointDaemon
from repro.core.recovery import compute_rsne as jcompute_rsne
from repro.core.recovery import device_ssn_floors as jfloors
from repro.core.recovery import load_columnar_segmented as jload
from repro.core.recovery import replay_columnar as jreplay
from repro.core.storage import DeviceSpec as JDeviceSpec
from repro.core.storage import StorageDevice as JStorageDevice
from repro.core.txn import Txn as JTxn
from repro_torch.core import recover
from repro_torch.core.checkpoint import CheckpointDaemon
from repro_torch.core.recovery import (
    compute_rsne,
    device_ssn_floors,
    load_columnar_segmented,
    replay_columnar,
)
from repro_torch.core.storage import DeviceSpec, StorageDevice
from repro_torch.core.txn import Txn
from repro_torch.kernels import ops as tops

PKGS = {
    "ref": (JTxn, JStorageDevice, JDeviceSpec),
    "port": (Txn, StorageDevice, DeviceSpec),
}
# (package, mode) -> recover(); the port's kernel mode runs on the CPU here
RECOVERIES = {
    ("ref", "scalar"): lambda devs, ck: jrecover(devs, ck, parallel=False, mode="scalar"),
    ("ref", "vectorized"): lambda devs, ck: jrecover(devs, ck, mode="vectorized"),
    ("ref", "pallas"): lambda devs, ck: jrecover(devs, ck, mode="pallas"),
    ("port", "scalar"): lambda devs, ck: recover(devs, ck, parallel=False, mode="scalar"),
    ("port", "vectorized"): lambda devs, ck: recover(devs, ck, mode="vectorized"),
    ("port", "kernel"): lambda devs, ck: recover(devs, ck, mode="kernel", device="cpu"),
}


def _txns(txn_cls, seed, n, ssn_base, n_keys=400):
    """``n`` records over ``n_keys`` keys: 0-3 writes each, a fifth of them
    with reads (RAW dependencies, held to RSNe)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        t = txn_cls(
            tid=1000 + ssn_base + i,
            write_set=[(f"key{rng.randrange(n_keys)}", rng.randbytes(rng.randrange(0, 40)))
                       for _ in range(rng.randrange(0, 4))],
            read_set=[("dep", 0)] if rng.random() < 0.2 else [],
        )
        t.ssn = ssn_base + i + 1
        out.append(t)
    return out


def _write_logs(pkg, directory, case, n_devices=2, per_seg=900):
    """Three segments per device (two sealed, one tail) of ``per_seg``
    records each, so every sealed tile carries more than
    ``_FUSED_MIN_LANES`` write lanes; returns the device file paths."""
    txn_cls, dev_cls, spec_cls = PKGS[pkg]
    os.makedirs(directory, exist_ok=True)
    paths = []
    for di in range(n_devices):
        path = os.path.join(directory, f"log_{di}.bin")
        # device 1 lags device 0, so RSNe cuts device 0's RAW records
        n_rec = 3 * per_seg - (150 if di == 1 else 0)
        txns = _txns(txn_cls, seed=di, n=n_rec, ssn_base=di * 5)
        d = dev_cls(spec_cls.null(), path=path, clock="virtual")
        for lo in (0, per_seg):
            d.write(b"".join(t.encode() for t in txns[lo: lo + per_seg]))
            d.seal(txns[lo + per_seg - 1].ssn)
        tail = b"".join(t.encode() for t in txns[2 * per_seg:])
        if case == "torn" and di == 0:
            tail = tail[:-9]            # a partial frame at the end of device 0
        d.write(tail)
        d.close()
        paths.append(path)
    if case == "corrupt":
        # flip one byte inside a mid-segment frame of device 1's first
        # sealed segment (its own file): the seal crc and the frame crc
        # fail, decode stops at that frame, and the fused pipeline declines
        seg0 = sorted(p for p in os.listdir(directory) if p.startswith("log_1.bin.seg-"))[0]
        with open(os.path.join(directory, seg0), "r+b") as f:
            f.seek(5000)
            b = f.read(1)
            f.seek(5000)
            f.write(bytes([b[0] ^ 0xFF]))
    return paths


def _open(pkg, paths):
    _, dev_cls, spec_cls = PKGS[pkg]
    return [dev_cls(spec_cls.null(), path=p, clock="virtual") for p in paths]


def _checkpoint(pkg, directory):
    """A checkpoint at RSN 900 whose image holds a key the log never wrote
    and two keys the log also writes, at SSNs below and at the RSN."""
    cls = JCheckpointDaemon if pkg == "ref" else CheckpointDaemon
    ck = cls(directory, n_threads=1, m_files=1, csn_fn=lambda: 900)
    ck.run_once([[(b"key3", b"from-ckpt", 900), (b"key7", b"old-ckpt", 2),
                  (b"only-in-ckpt", b"img", 5)]], epoch=1)
    return directory


def _log_bytes(directory):
    return {p.name: p.read_bytes() for p in directory.iterdir()
            if not p.name.endswith(".json")}


def _key(st):
    return (st.data, st.rsns, st.rsne, st.n_replayed, st.n_skipped_uncommitted)


@pytest.mark.parametrize("case", ["plain", "torn", "corrupt", "checkpoint"])
def test_recovered_state_identical_across_packages(case, tmp_path, monkeypatch):
    calls = []
    real_scan = tops.fused_replay_scan
    monkeypatch.setattr(tops, "fused_replay_scan",
                        lambda *a, **k: calls.append(1) or real_scan(*a, **k))
    states = {}
    for writer in ("ref", "port"):
        paths = _write_logs(writer, str(tmp_path / writer), case)
        ck = _checkpoint(writer, str(tmp_path / f"ck-{writer}")) \
            if case == "checkpoint" else None
        for (pkg, mode), run in RECOVERIES.items():
            devs = _open(pkg, paths)
            st = run(devs, ck)
            for d in devs:
                d.close()
            states[(writer, pkg, mode)] = st
    # the two writers framed byte-identical logs (the segment manifests
    # differ only in the absolute segment paths they name)
    assert _log_bytes(tmp_path / "ref") == _log_bytes(tmp_path / "port")
    want = _key(states[("ref", "ref", "scalar")])
    assert want[0] and want[3] and want[4], case   # replayed and skipped both
    for k, st in states.items():
        assert _key(st) == want, (case, k)
    for writer in ("ref", "port"):
        ref_fused = states[(writer, "ref", "pallas")].report.fused
        assert states[(writer, "port", "kernel")].report.fused == ref_fused
        assert ref_fused == (case != "corrupt"), case
    assert calls, "the kernel mode never reached fused_replay_scan"
    if case == "checkpoint":
        assert want[1] == 900
        assert want[0][b"only-in-ckpt"] == (b"img", 5)


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_replay_columnar_kernel_apply_matches_reference(with_checkpoint, tmp_path):
    """``replay_columnar(use_kernel=True)`` — the ``fused_replay_apply``
    path — against the reference's on the same decoded logs, with and
    without a checkpoint base."""
    paths = _write_logs("port", str(tmp_path / "logs"), "plain")
    base = None
    if with_checkpoint:
        from repro_torch.core.checkpoint import load_latest_checkpoint

        base = load_latest_checkpoint(_checkpoint("port", str(tmp_path / "ck"))).data
    jdevs, tdevs = _open("ref", paths), _open("port", paths)
    jlogs = jload(jdevs, parallel=False)
    tlogs = load_columnar_segmented(tdevs, parallel=False)
    rsne = compute_rsne(tlogs, floors=device_ssn_floors(tdevs))
    assert rsne == jcompute_rsne(jlogs, floors=jfloors(jdevs))
    want = jreplay(jlogs, rsne, base=base, use_kernel=True)
    assert want == jreplay(jlogs, rsne, base=base)
    shapes0 = tops.fused_cache_sizes()["fused_replay_apply"]
    got = replay_columnar(tlogs, rsne, base=base, use_kernel=True, device="cpu")
    assert got == want
    assert replay_columnar(tlogs, rsne, base=base) == want
    assert tops.fused_cache_sizes()["fused_replay_apply"] >= max(shapes0, 1)
