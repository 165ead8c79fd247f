"""The port's checkpoints and crash-resume against the reference's.

* Port only, mirroring ``tests/test_checkpoint_elastic.py``: the round
  trip, the corruption fallback, async saves with retention, a crash at
  ``fail_at`` and a resume that completes, error feedback of the gradient
  compression.
* Across packages: a checkpoint the port writes restores in the
  reference and one the reference writes restores in the port, equal
  leaf for leaf (fp32 and int32), with equal manifests (keys, shapes,
  dtypes, sha1s).  bf16: the port writes a bf16 tensor as the raw 2-byte
  words the reference's file holds, under the reference's manifest dtype
  ``"bfloat16"`` and the sha1 of the same bytes, and reads the
  reference's bf16 checkpoint back bit for bit.  The reference's own
  restore refuses bf16 entries (JAX takes no void array; ROADMAP §3): on
  the port's file it falls back exactly as on its own.

All comparisons are exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train.checkpoint import CheckpointManager as RefManager
from repro_torch.train import optimizer, train_loop
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compression import (compress_grads, decompress_grads,
                                           init_error)
from repro_torch.train.tree import leaves


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(16, 8).astype(np.float32),
            "b": {"c": rng.randn(4).astype(np.float32),
                  "d": rng.randint(0, 5, (3, 3)).astype(np.int32)}}


def _tree(seed=0):
    a = _arrays(seed)
    return {"a": torch.from_numpy(a["a"]),
            "b": {"c": torch.from_numpy(a["b"]["c"]),
                  "d": torch.from_numpy(a["b"]["d"])}}


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:010d}", "manifest.json")) as f:
        m = json.load(f)
    return m["arrays"], m["extra"]


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(10, t, extra={"note": "x"})
    step, out, extra = mgr.restore_latest(t, device="cpu")
    assert step == 10 and extra["note"] == "x"
    for a, b in zip(leaves(t), leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_corruption_falls_back(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, t)
    mgr.save(2, _tree(99))
    npz = os.path.join(str(tmp_path), "step_0000000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 64)
    step, out, _ = mgr.restore_latest(t, device="cpu")
    assert step == 1          # fell back to the older valid checkpoint
    assert torch.equal(out["a"], t["a"])
    assert "[ckpt] step 2 invalid" in capsys.readouterr().out


def test_async_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, t)
    mgr.wait()
    assert mgr.list_steps() == [3, 4]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_crash_resume(tmp_path):
    """Inject a failure mid-training; a fresh run resumes from the last
    checkpoint and completes."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64, 4).astype(np.float32))
    y = x @ torch.tensor([1.0, -1, 2, 0.5])
    params = {"w": torch.zeros((4,))}

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

    def data():
        while True:
            yield {"x": x, "y": y}

    cfg = train_loop.TrainConfig(
        steps=30, ckpt_every=10, ckpt_dir=str(tmp_path), log_every=1000,
        opt=optimizer.AdamWConfig(lr=0.2, warmup_steps=2, total_steps=30,
                                  weight_decay=0.0))
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop.run(params, loss_fn, data(), cfg, fail_at=15)
    assert 10 in CheckpointManager(str(tmp_path)).list_steps()
    _, opt, losses = train_loop.run(params, loss_fn, data(), cfg)
    assert len(losses) == 20 and int(opt.step) == 30
    assert losses[-1] < 0.1
    assert CheckpointManager(str(tmp_path)).list_steps()[-1] == 30


def test_gradient_compression_error_feedback():
    g = {"w": torch.from_numpy(np.random.RandomState(0).randn(128) * 3)
         .float()}
    q, err2 = compress_grads(g, init_error(g))
    back = decompress_grads(q)
    scale = float(g["w"].abs().max()) / 127
    assert float((back["w"] - g["w"]).abs().max()) <= scale
    np.testing.assert_allclose(err2["w"].numpy(),
                               (g["w"] - back["w"]).numpy(), atol=1e-6)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t = _tree(3)
    CheckpointManager(str(tmp_path / "p")).save(7, t, extra={"k": 1})
    RefManager(str(tmp_path / "r")).save(
        7, jax.tree.map(jnp.asarray, _arrays(3)), extra={"k": 1})
    step, out, extra = RefManager(str(tmp_path / "p")).restore_latest(
        jax.tree.map(jnp.asarray, _arrays(0)))
    assert step == 7 and extra == {"k": 1}
    for a, b in zip(leaves(t), jax.tree.leaves(out)):
        assert str(a.numpy().dtype) == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert _manifest(tmp_path / "p", 7) == _manifest(tmp_path / "r", 7)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    RefManager(str(tmp_path)).save(5, jax.tree.map(jnp.asarray, _arrays(4)))
    step, out, _ = CheckpointManager(str(tmp_path)).restore_latest(
        _tree(0), device="cpu")
    assert step == 5
    for a, b in zip(leaves(out), leaves(_tree(4))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _bf16_values():
    v = np.random.RandomState(5).randn(6, 10).astype(np.float32)
    v[0, :4] = [0.0, -0.0, 1e-40, 3.0e38]    # signed zero, subnormal, large
    return torch.from_numpy(v).to(torch.bfloat16)


def test_bf16_checkpoints_across_packages(tmp_path):
    t = _bf16_values()
    ref_tree = {"w": jnp.asarray(t.float().numpy()).astype(jnp.bfloat16),
                "n": jnp.arange(3, dtype=jnp.int32)}
    port_tree = {"w": t, "n": torch.arange(3, dtype=torch.int32)}
    RefManager(str(tmp_path / "r")).save(2, ref_tree)
    CheckpointManager(str(tmp_path / "p")).save(2, port_tree)
    # the same manifest: dtype "bfloat16", the sha1 of the same words
    mr, mp = _manifest(tmp_path / "r", 2)[0], _manifest(tmp_path / "p", 2)[0]
    assert mp == mr and mp["w"]["dtype"] == "bfloat16"
    # the same 2-byte words in the npz
    for d in ("r", "p"):
        a = np.load(tmp_path / d / "step_0000000002" / "arrays.npz")["w"]
        assert a.dtype.itemsize == 2 and a.dtype.kind == "V"
        np.testing.assert_array_equal(
            a.view(np.int16), t.view(torch.int16).numpy())
    # the port reads either file back bit for bit
    for d in ("r", "p"):
        step, out, _ = CheckpointManager(str(tmp_path / d)).restore_latest(
            port_tree, device="cpu")
        assert step == 2 and out["w"].dtype == torch.bfloat16
        assert torch.equal(out["w"].view(torch.int16), t.view(torch.int16))
        assert torch.equal(out["n"], port_tree["n"])
    # the reference refuses bf16 entries, on its own file and on the port's
    for d in ("r", "p"):
        assert RefManager(str(tmp_path / d)).restore_latest(ref_tree) == \
            (None, None, None)
