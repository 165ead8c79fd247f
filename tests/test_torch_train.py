"""The port's LM training path against the reference's.

The five LM configurations at their REDUCED sizes (2 layers, d_model 128,
fp32), with the reference's ``transformer.init(c, PRNGKey(0))``
parameters carried over by ``convert.lm_params``:

* ``forward_hidden`` and ``loss_fn`` with its gradients against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` (labels with
  masked positions, four cross-entropy chunks), leaf by leaf, under each
  ``remat`` (``none``, ``full``, ``dots``: the same values);
* ``optimizer.apply`` against the reference from equal parameters, grads
  and state (``convert.opt_state``), and its schedule and global norm;
* the compression round trip, ``lm_batches`` bit for bit, ``elastic``'s
  arithmetic, the registry;
* ``make_train_step`` with 2 microbatches against the reference's;
* port-only, mirroring ``tests/test_models_lm.py``: a train step reduces
  the loss; the CLI (``repro_torch.launch.train``) runs at REDUCED on the
  CPU, then resumes after ``--fail-at``.

Tolerances, each with its reason:

* the loss: 1e-5 relative (fp32 sums in other orders);
* ``forward_hidden``: 1e-4 of the largest magnitude, as
  ``test_torch_lm.py``'s forward;
* gradients: 5e-3 of each leaf's largest magnitude.  The reference draws
  each stacked layer leaf at 1/√L (L = 2), so attention logits spread over
  d_model / L and softmax rows nearly tie; there a float32 rounding moves
  a gradient by up to ~1e-3 of the leaf's largest entry.  Both packages
  are that far from the same gradients computed in float64 (granite's
  worst leaf: the reference 1.5e-3, the port 7.8e-4; the two 2.3e-3
  apart), so the bar measures the port, not the conditioning;
* the optimizer: 1e-6 of max(1, |want|) (fp32 elementwise, the same
  order, ``cos`` and ``pow`` from two libraries);
* compression, ``lm_batches``: exact.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import granite_moe_3b_a800m as ref_granite
from repro.configs import minicpm3_4b as ref_minicpm
from repro.configs import minitron_8b as ref_minitron
from repro.configs import moonshot_v1_16b_a3b as ref_moonshot
from repro.configs import registry as ref_registry
from repro.configs import yi_6b as ref_yi
from repro.data import synthetic as ref_synthetic
from repro.models import transformer as ref_tr
from repro.train import compression as ref_comp
from repro.train import elastic as ref_elastic
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_loop
from repro_torch import convert
from repro_torch.configs import (granite_moe_3b_a800m, minicpm3_4b,
                                 minitron_8b, moonshot_v1_16b_a3b, registry,
                                 yi_6b)
from repro_torch.data import synthetic
from repro_torch.data.pipeline import PrefetchingLoader
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tr
from repro_torch.train import compression, elastic, optimizer, train_loop
from repro_torch.train.tree import leaves, map_tree

ARCHS = {"yi_6b": (ref_yi, yi_6b), "minitron_8b": (ref_minitron, minitron_8b),
         "granite_moe_3b_a800m": (ref_granite, granite_moe_3b_a800m),
         "moonshot_v1_16b_a3b": (ref_moonshot, moonshot_v1_16b_a3b),
         "minicpm3_4b": (ref_minicpm, minicpm3_4b)}
LOSS_REL, HIDDEN_REL, GRAD_REL, OPT_REL = 1e-5, 1e-4, 5e-3, 1e-6
B, S, CE_CHUNK = 2, 64, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(c, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, c.vocab, (B, S)).astype(np.int32)
    labels = rng.randint(0, c.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1                        # masked positions
    return toks, labels


def _ref_tree(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _walk(ref_tree):
    """(path, reference leaf) in the reference's order."""
    return jax.tree_util.tree_flatten_with_path(ref_tree)[0]


@pytest.fixture(scope="module", params=sorted(ARCHS))
def run(request):
    """The reference's loss, gradients and final hidden states on one
    batch, once per configuration."""
    ref_mod, port_mod = ARCHS[request.param]
    rc, pc = ref_mod.REDUCED, port_mod.REDUCED
    rp, _ = ref_tr.init(rc, jax.random.PRNGKey(0))
    toks, labels = _batch(rc)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: ref_tr.loss_fn(p, rc, jnp.asarray(toks),
                                 jnp.asarray(labels), ce_chunk=CE_CHUNK)))(rp)
    hidden, aux = jax.jit(ref_tr.forward_hidden, static_argnums=(1,))(
        rp, rc, jnp.asarray(toks))
    return dict(rc=rc, pc=pc, rp=rp, toks=toks, labels=labels,
                loss=float(loss), grads=grads, hidden=np.asarray(hidden),
                aux=float(aux))


def _port_loss_and_grads(run, remat):
    c = dataclasses.replace(run["pc"], remat=remat)
    params = convert.lm_params(run["rp"], device="cpu")
    batch = {"tokens": torch.from_numpy(run["toks"]),
             "labels": torch.from_numpy(run["labels"])}
    return train_loop.value_and_grad(
        lambda p, b: tr.loss_fn(p, c, b["tokens"], b["labels"],
                                ce_chunk=CE_CHUNK), params, batch)


def test_forward_hidden_matches_reference(run):
    params = convert.lm_params(run["rp"], device="cpu")
    with torch.no_grad():
        x, aux = tr.forward_hidden(params, run["pc"],
                                   torch.from_numpy(run["toks"]))
    want = run["hidden"]
    assert tuple(x.shape) == want.shape and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), want,
                               atol=HIDDEN_REL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), run["aux"], rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == (run["pc"].moe is not None)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_reference(run, remat):
    loss, grads = _port_loss_and_grads(run, remat)
    assert abs(float(loss) - run["loss"]) <= LOSS_REL * abs(run["loss"])
    n = 0
    for path, want in _walk(run["grads"]):
        got = _ref_tree(grads, path)
        want = np.asarray(want, np.float32)
        assert tuple(got.shape) == want.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=GRAD_REL * np.abs(want).max(),
                                   err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(leaves(grads))


def test_remat_policies_agree(run):
    """Rematerialisation changes what is saved, not what is computed."""
    base = _port_loss_and_grads(run, "none")
    for remat in ("full", "dots"):
        other = _port_loss_and_grads(run, remat)
        assert float(other[0]) == float(base[0])
        for a, b in zip(leaves(other[1]), leaves(base[1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * float(b.abs().max()))


def test_loss_refuses_a_ragged_chunking():
    c = yi_6b.REDUCED
    params = tr.init(c, device="cpu")
    toks = torch.zeros((1, 40), dtype=torch.int32)
    with pytest.raises(TypeError, match="cannot reshape"):
        tr.loss_fn(params, c, toks, toks, ce_chunk=16)
    assert torch.isfinite(tr.loss_fn(params, c, toks, toks, ce_chunk=20))


def _state(seed, shapes):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"w": (16, 8), "b": (8,), "z": (3, 5)}


def test_optimizer_apply_matches_reference():
    """Three updates from equal parameters, grads and state: parameters,
    moments, step, grad norm and lr."""
    cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    rcfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
    rp = {k: jnp.asarray(v) for k, v in _state(0, SHAPES).items()}
    ro = ref_opt.init(rp)
    pp = {k: torch.from_numpy(np.asarray(v)) for k, v in rp.items()}
    po = convert.opt_state(ro, device="cpu", like=pp)
    for i in range(3):
        g = _state(10 + i, SHAPES)
        g["w"] *= 50.0                   # clipped: norm above grad_clip
        rp, ro, rm = ref_opt.apply(rp, {k: jnp.asarray(v)
                                        for k, v in g.items()}, ro, rcfg)
        pp, po, pm = optimizer.apply(pp, {k: torch.from_numpy(v)
                                          for k, v in g.items()}, po, cfg)
        for want, got in ((rp, pp), (ro.m, po.m), (ro.v, po.v)):
            for k in SHAPES:
                w = np.asarray(want[k])
                np.testing.assert_allclose(
                    got[k].numpy(), w, rtol=0,
                    atol=OPT_REL * max(1.0, np.abs(w).max()))
        assert int(po.step) == int(ro.step) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                       rtol=OPT_REL)


def test_optimizer_keeps_fp32_moments_and_the_param_type():
    p = {"a": torch.ones((4, 4), dtype=torch.bfloat16)}
    o = optimizer.init(p)
    assert o.m["a"].dtype == torch.float32 and o.step.dtype == torch.int32
    new, o2, _ = optimizer.apply(p, {"a": torch.full((4, 4), 0.5,
                                                     dtype=torch.bfloat16)},
                                 o, optimizer.AdamWConfig())
    assert new["a"].dtype == torch.bfloat16 and o2.v["a"].dtype == \
        torch.float32 and int(o2.step) == 1
    assert torch.equal(p["a"], torch.ones((4, 4), dtype=torch.bfloat16))


def test_schedule_and_global_norm_match_reference():
    cfg = optimizer.AdamWConfig(warmup_steps=10, total_steps=50)
    rcfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(
            float(optimizer.schedule(cfg, torch.tensor(step,
                                                       dtype=torch.int32))),
            float(ref_opt.schedule(rcfg, jnp.asarray(step, jnp.int32))),
            rtol=OPT_REL)
    tree = {"b": {"x": np.arange(7, dtype=np.float32)},
            "a": np.full((3, 3), -2.5, np.float32)}
    np.testing.assert_allclose(
        float(optimizer.global_norm(map_tree(torch.from_numpy, tree))),
        float(ref_opt.global_norm(tree)), rtol=1e-7)


def test_compression_round_trip_matches_reference():
    rng = np.random.RandomState(0)
    g = {"w": rng.randn(128).astype(np.float32) * 3,
         "v": {"u": (rng.randn(4, 6) * 1e-3).astype(np.float32)}}
    # exact halves of the quantization step: round half to even
    g["w"][:4] = np.float32(127 / 3.0) * np.array([0.5, 1.5, -2.5, 3.5],
                                                  np.float32)
    err = {"w": rng.randn(128).astype(np.float32) * 0.01,
           "v": {"u": np.zeros((4, 6), np.float32)}}
    rq, re_ = ref_comp.compress_grads(g, err)
    pq, pe = compression.compress_grads(map_tree(torch.from_numpy, g),
                                        map_tree(torch.from_numpy, err))
    for path, (q, s) in jax.tree_util.tree_flatten_with_path(
            rq, is_leaf=lambda x: isinstance(x, tuple))[0]:
        pq_, ps_ = _ref_tree(pq, path)
        assert pq_.dtype == torch.int8
        np.testing.assert_array_equal(pq_.numpy(), np.asarray(q))
        assert float(ps_) == float(s)
    for a, b in zip(leaves(pe), jax.tree.leaves(re_)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(leaves(compression.decompress_grads(pq)),
                    jax.tree.leaves(ref_comp.decompress_grads(rq))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q, s = compression.quantize_int8(torch.tensor([0.5, 1.5, 2.5, -0.5,
                                                   127.0]))
    assert q.tolist() == [0, 2, 2, 0, 127] and float(s) == 1.0


def test_topk_sparsify_matches_reference():
    rng = np.random.RandomState(1)
    g = rng.randint(-4, 5, (10, 30)).astype(np.float32)   # many ties
    for frac in (0.01, 0.1, 0.5):
        rv, ri, rs = ref_comp.topk_sparsify(jnp.asarray(g), frac)
        pv, pi, ps = compression.topk_sparsify(torch.from_numpy(g), frac)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        assert tuple(ps) == tuple(rs)


@pytest.mark.parametrize("start", [0, 24])
def test_lm_batches_match_reference_bit_for_bit(start):
    a = ref_synthetic.lm_batches(512, 3, 17, seed=4, start_index=start)
    b = synthetic.lm_batches(512, 3, 17, seed=4, start_index=start)
    for _ in range(4):
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])


def test_prefetching_loader_copies_batches_to_the_device():
    gen = synthetic.lm_batches(64, 2, 8, seed=1)
    want = [next(synthetic.lm_batches(64, 2, 8, seed=1, start_index=i))
            for i in (0, 2, 4)]
    loader = PrefetchingLoader(gen, device="cpu")
    for w in want:
        got = next(loader)
        assert got["tokens"].device == torch.device("cpu")
        np.testing.assert_array_equal(got["tokens"].numpy(), w["tokens"])
    loader.close()
    items = list(PrefetchingLoader(iter([{"x": np.ones(2)}])))
    assert len(items) == 1 and isinstance(items[0]["x"], np.ndarray)


def test_elastic_and_registry_match_reference():
    for gb, old, new in ((256, 8, 6), (100, 4, 4), (7, 2, 3)):
        assert elastic.rebalance_batch_size(gb, old, new) == \
            ref_elastic.rebalance_batch_size(gb, old, new)
        assert elastic.data_cursor_after_restart(gb, new) == \
            ref_elastic.data_cursor_after_restart(gb, new)
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    for arch in ARCHS:
        for get, ref_get in ((registry.get_arch, ref_registry.get_arch),
                             (registry.get_reduced,
                              ref_registry.get_reduced)):
            (pc, pf), (rc, rf) = get(arch.replace("_", "-")), ref_get(arch)
            assert pf == rf == "lm"
            assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert registry.get_reduced("paper_isn")[1] == "isn"
    for arch in ("dimenet", "bert4rec", "deepfm", "xdeepfm"):
        (pc, pf), (rc, rf) = registry.get_arch(arch), ref_registry.get_arch(
            arch)
        assert pf == rf and dataclasses.asdict(pc) == dataclasses.asdict(rc)


def test_make_train_step_with_microbatches_matches_reference():
    """One step of 2 microbatches from the same parameters: the loss, and
    the parameters after AdamW's first step.  That step moves each entry
    by lr · g / (|g| + eps) (about lr · sign(g)) plus the decay, so where
    a gradient is near 0 and its rounding differs, its sign — and the
    entry — can differ by up to 2 lr; every other entry agrees to 1e-5."""
    rc, pc = ref_yi.REDUCED, yi_6b.REDUCED
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rp, _ = ref_tr.init(rc, jax.random.PRNGKey(0))
    toks, labels = _batch(rc, seed=3)
    rstep = ref_loop.make_train_step(
        lambda p, b: ref_tr.loss_fn(p, rc, b["tokens"], b["labels"],
                                    ce_chunk=CE_CHUNK),
        ref_loop.TrainConfig(microbatches=2,
                             opt=ref_opt.AdamWConfig(**ocfg)))
    rnew, ropt, rloss, _ = jax.jit(rstep)(rp, ref_opt.init(rp),
                                 {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
    params = convert.lm_params(rp, device="cpu")
    pstep = train_loop.make_train_step(
        lambda p, b: tr.loss_fn(p, pc, b["tokens"], b["labels"],
                                ce_chunk=CE_CHUNK),
        train_loop.TrainConfig(microbatches=2,
                               opt=optimizer.AdamWConfig(**ocfg)))
    pnew, popt, ploss, _ = pstep(params, optimizer.init(params),
                                 {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    assert abs(float(ploss) - float(rloss)) <= LOSS_REL * float(rloss)
    assert int(popt.step) == int(ropt.step) == 1
    flips = total = 0
    for path, want in _walk(rnew):
        got = _ref_tree(pnew, path).numpy()
        want = np.asarray(want, np.float32)
        diff = np.abs(got - want)
        assert diff.max() <= 2.2 * ocfg["lr"], jax.tree_util.keystr(path)
        flips += int((diff > 1e-5).sum())
        total += diff.size
    assert flips <= 1e-3 * total


def test_train_step_reduces_loss():
    c = yi_6b.REDUCED
    params = tr.init(c, 0, device="cpu")
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(np.tile(rng.randint(0, c.vocab, (4, 8)),
                                    (1, 4)).astype(np.int32))
    step = train_loop.make_train_step(
        lambda p, b: tr.loss_fn(p, c, b, b),
        train_loop.TrainConfig(opt=optimizer.AdamWConfig(
            lr=3e-3, warmup_steps=2, total_steps=30)))
    opt, losses = optimizer.init(params), []
    for _ in range(15):
        params, opt, loss, _ = step(params, opt, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9


def test_cli_trains_then_resumes_after_a_crash(tmp_path, capsys):
    args = ["--device", "cpu", "--arch", "yi-6b", "--steps", "52",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="injected failure at step 50"):
        train_cli.main(args + ["--fail-at", "50"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] arch=yi-6b-reduced params=0.5M devices=1"
    assert [re.sub(r"loss=\S+ \(\S+", "", x) for x in out[1:]] == \
        [f"[train] step {s}  steps/s)" for s in (10, 20, 30, 40, 50)]
    train_cli.main(args)
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "[train] resumed from step 50"
    assert re.fullmatch(r"\[train\] done: loss \d+\.\d{3} -> \d+\.\d{3}",
                        out[-1])
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_0000000050", "step_0000000052"]
