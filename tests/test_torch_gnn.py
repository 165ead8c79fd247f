"""The port's GNN family (DimeNet and the neighbor sampler) against the
reference's.

DimeNet at REDUCED (2 blocks, d_hidden 32, fp32), with the reference's
``gnn.init(c, PRNGKey(0))`` parameters carried over by
``convert.gnn_params``, on ``make_molecule_batch`` (4 graphs of 12 nodes
and 24 edges, a NumPy seed):

* the configuration and the registry, the parameter tree's shapes against
  the reference's abstract init at CONFIG and REDUCED;
* ``bessel_rbf`` and ``angular_sbf``; ``forward``, ``loss_fn`` and its
  gradients against ``jax.value_and_grad``, leaf by leaf; the same with
  bf16 parameters on the fp32 batch (JAX's type promotion);
* ``neighbor_sample`` and ``build_triplets`` bit-equal to the reference's
  for the same ``PRNGKey`` (``core/prng`` is JAX's threefry bit for bit);
* ``make_molecule_batch`` and ``molecule_batches`` bit for bit;
* port-only, as ``tests/test_models_gnn_recsys.py`` checks the reference:
  a few AdamW steps lower the loss.

Tolerances: the bases 1e-6 of max(1, |want|); the forward 1e-5 of its
largest magnitude; the loss 1e-5 relative; gradients 1e-4 of each leaf's
largest magnitude (fp32 sums and the bilinear einsum in other orders), bf16
gradients one bf16 ulp (4e-3) of it; the samplers and the generators
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry
from repro.data import synthetic as ref_synthetic
from repro.models import gnn as ref_gnn
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import prng
from repro_torch.data import synthetic
from repro_torch.models import gnn
from repro_torch.train import optimizer, train_loop

LOSS_REL, OUT_REL, GRAD_REL, BASIS_TOL = 1e-5, 1e-5, 1e-4, 1e-6
BF16_GRAD_REL = 4e-3
FORWARD_KEYS = ("feat", "pos", "edge_src", "edge_dst", "trip_kj", "trip_ji",
                "edge_mask", "trip_mask", "node_mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several pytest workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_walk(v, f"{prefix}/{k}" if prefix else k))
    return out


def _flat(tree):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in _walk(tree).items()}


def _rel(got, want):
    top = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / (top if top > 0 else 1.0)


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters, batch, forward, loss and gradients (run
    once for the module)."""
    c, _ = ref_registry.get_reduced("dimenet")
    params = jax.jit(lambda key: ref_gnn.init(c, key)[0])(
        jax.random.PRNGKey(0))
    host = ref_synthetic.make_molecule_batch(np.random.RandomState(0), 4, 12,
                                             24, c.d_feat)
    b = jax.tree.map(jnp.asarray, host)
    out = jax.jit(lambda p, b_: ref_gnn.forward(
        p, c, *(b_[k] for k in FORWARD_KEYS)))(params, b)
    loss, grads = jax.jit(jax.value_and_grad(ref_gnn.loss_fn),
                          static_argnums=1)(params, c, b)
    return dict(params=params, host=host, out=np.asarray(out),
                loss=float(loss), grads=_flat(grads))


def _port(ref):
    c, _ = registry.get_reduced("dimenet")
    p = convert.gnn_params(ref["params"], "cpu")
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["host"].items()}
    return c, p, b


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
def test_config_and_param_shapes_match_reference(which):
    get, ref_get = ((registry.get_arch, ref_registry.get_arch)
                    if which == "CONFIG" else
                    (registry.get_reduced, ref_registry.get_reduced))
    (pc, pf), (rc, rf) = get("dimenet"), ref_get("dimenet")
    assert pf == rf == "gnn"
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    want, _ = ref_gnn.init(rc, abstract=True)
    want = {k: tuple(v.shape) for k, v in _walk(want).items()}
    got = {k: leaf.shape for k, leaf in _walk(gnn.param_shapes(pc)).items()}
    assert got == want


def test_init_draws_the_reference_scales():
    c, _ = registry.get_reduced("dimenet")
    p = _flat(gnn.init(c, seed=3, device="cpu"))
    for key, leaf in _walk(gnn.param_shapes(c)).items():
        assert p[key].shape == leaf.shape and p[key].dtype == np.float32
        if leaf.fill == "normal":
            assert 0.5 * leaf.scale < float(p[key].std()) < 1.5 * leaf.scale
        else:
            assert np.all(p[key] == 0.0), key
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gnn.init(c)


@pytest.mark.parametrize("n_radial,n_spherical,cutoff", [(4, 3, 5.0),
                                                         (6, 7, 5.0),
                                                         (5, 2, 3.0)])
def test_bases_match_reference(n_radial, n_spherical, cutoff):
    """Distances from 0 (clamped at 1e-6) past the cutoff, angles in [0,
    π]."""
    rng = np.random.RandomState(n_radial)
    d = np.concatenate([[0.0, 1e-7], rng.random_sample(60) * 7.0]) \
        .astype(np.float32)
    angle = (rng.random_sample(62) * np.pi).astype(np.float32)
    want = ref_gnn.bessel_rbf(jnp.asarray(d), n_radial, cutoff)
    got = gnn.bessel_rbf(torch.from_numpy(d), n_radial, cutoff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=BASIS_TOL, atol=BASIS_TOL)
    want = ref_gnn.angular_sbf(jnp.asarray(d), jnp.asarray(angle),
                               n_spherical, n_radial, cutoff)
    got = gnn.angular_sbf(torch.from_numpy(d), torch.from_numpy(angle),
                          n_spherical, n_radial, cutoff)
    assert got.shape == (62, n_spherical * n_radial)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=BASIS_TOL, atol=BASIS_TOL)


def test_forward_matches_reference(ref):
    c, p, b = _port(ref)
    with torch.no_grad():
        out = gnn.forward(p, c, *(b[k] for k in FORWARD_KEYS))
    assert out.shape == ref["out"].shape == (48, c.d_out)
    assert _rel(out.numpy(), ref["out"]) <= OUT_REL


def test_loss_and_gradients_match_reference(ref):
    c, p, b = _port(ref)
    loss, grads = train_loop.value_and_grad(
        lambda params, batch: gnn.loss_fn(params, c, batch), p, b)
    assert abs(float(loss) - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
    got = _flat(grads)
    assert got.keys() == ref["grads"].keys()
    for key, w in ref["grads"].items():
        assert _rel(got[key], w) <= GRAD_REL, key


@pytest.fixture(scope="module")
def ref_bf16(ref):
    """The reference's DimeNet at REDUCED with ``dtype="bfloat16"`` (bf16
    parameters from ``init(c, PRNGKey(0))``) on the same fp32 molecule
    batch: JAX promotes each fp32 @ bf16 product to fp32, so the loss is
    fp32 and the gradients bf16."""
    c = dataclasses.replace(ref_registry.get_reduced("dimenet")[0],
                            dtype="bfloat16")
    params = jax.jit(lambda key: ref_gnn.init(c, key)[0])(
        jax.random.PRNGKey(0))
    b = jax.tree.map(jnp.asarray, ref["host"])
    loss, grads = jax.jit(jax.value_and_grad(ref_gnn.loss_fn),
                          static_argnums=1)(params, c, b)
    return dict(params=params, loss=loss, grads=grads)


def test_bf16_parameters_match_reference(ref, ref_bf16):
    """bf16 parameters on the fp32 batch (ROADMAP §3 open 16): every
    product in the promoted type, as JAX's; the loss fp32 within 1e-5
    relative, every gradient leaf bf16 within one bf16 ulp (4e-3) of its
    largest magnitude (both sides round fp32 gradients to bf16 once)."""
    c = dataclasses.replace(registry.get_reduced("dimenet")[0],
                            dtype="bfloat16")
    p = convert.gnn_params(ref_bf16["params"], "cpu")
    assert all(t.dtype == torch.bfloat16 for t in _walk(p).values())
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["host"].items()}
    loss, grads = train_loop.value_and_grad(
        lambda params, batch: gnn.loss_fn(params, c, batch), p, b)
    assert ref_bf16["loss"].dtype == jnp.float32
    assert loss.dtype == torch.float32
    want_loss = float(ref_bf16["loss"])
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    want = _walk(ref_bf16["grads"])
    got = _walk(grads)
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert w.dtype == jnp.bfloat16 and got[key].dtype == torch.bfloat16
        assert _rel(got[key].float().numpy(),
                    np.asarray(w, np.float32)) <= BF16_GRAD_REL, key


def test_adamw_steps_lower_the_loss(ref):
    c, p, b = _port(ref)
    cfg = optimizer.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    opt = optimizer.init(p)
    losses = []
    for _ in range(8):
        loss, grads = train_loop.value_and_grad(
            lambda params, batch: gnn.loss_fn(params, c, batch), p, b)
        p, opt, _ = optimizer.apply(p, grads, opt, cfg)
        losses.append(float(loss))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0]


@pytest.mark.parametrize("seed,fanouts", [(0, (5, 3)), (1, (15, 10)),
                                          (2, (4,)), (3, (2, 2, 2))])
def test_neighbor_sample_bit_equal(seed, fanouts):
    """Nodes of degree 0 (masked edges), the same key: edges and masks
    exact."""
    rng = np.random.RandomState(seed)
    n, max_deg = 300, 16
    neighbors = rng.randint(0, n, (n, max_deg)).astype(np.int32)
    degrees = rng.randint(0, max_deg + 1, n).astype(np.int32)
    seeds = rng.choice(n, 24, replace=False).astype(np.int32)
    want = jax.jit(ref_gnn.neighbor_sample, static_argnums=3)(
        jnp.asarray(neighbors),
        jnp.asarray(degrees), jnp.asarray(seeds), fanouts,
        jax.random.PRNGKey(seed))
    got = gnn.neighbor_sample(torch.from_numpy(neighbors),
                              torch.from_numpy(degrees),
                              torch.from_numpy(seeds), fanouts,
                              prng.PRNGKey(seed))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["edge_src"].dtype == torch.int64


@pytest.mark.parametrize("seed,e,budget", [(0, 256, 512), (1, 1000, 300),
                                           (2, 37, 64)])
def test_build_triplets_bit_equal(seed, e, budget):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, 64, e).astype(np.int32)
    dst = rng.randint(0, 64, e).astype(np.int32)
    want = jax.jit(ref_gnn.build_triplets, static_argnums=2)(
        jnp.asarray(src), jnp.asarray(dst), budget, jax.random.PRNGKey(seed))
    got = gnn.build_triplets(torch.from_numpy(src), torch.from_numpy(dst),
                             budget, prng.PRNGKey(seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_molecule_batches_bit_for_bit():
    want = ref_synthetic.molecule_batches(3, 10, 20, 8, trip_factor=3,
                                          seed=2)
    got = synthetic.molecule_batches(3, 10, 20, 8, trip_factor=3, seed=2)
    for _ in range(2):
        w, g = next(want), next(got)
        assert w.keys() == g.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
    w = ref_synthetic.make_molecule_batch(np.random.RandomState(5), 2, 30,
                                          64, 16)
    g = synthetic.make_molecule_batch(np.random.RandomState(5), 2, 30, 64, 16)
    for key in w:
        np.testing.assert_array_equal(g[key], w[key])
