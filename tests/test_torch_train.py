"""The port's training path against the JAX package's, end to end: the
binary matmul with its STE backward, the train forwards of the paper's MLP
and CNN, their gradients, and one whole train step (forward, square hinge
loss, gradients, S-AdaMax, apply, clip), at small sizes.

Sizes: CNN widths (8, 8, 16, 16, 32, 32), FC 32, 8x8x3 images, batch 4; MLP
64-32x3-10, batch 8. Weights, BN statistics and inputs are made with numpy
from a seed and fed to both packages (`repro_torch.convert` carries trees
across). Stochastic binarization: JAX's own `jax.random.uniform` draws are
recomputed here site by site from its key chain and fed to the port as
`noise` (`models.paper_nets` names the sites).

The reference's binary convs sign their input with the zero-gradient
`ref.sign_pm1` (src/repro/kernels/ops.py:207), so JAX's gradient stops at
every binary conv; the port's sign is straight-through, as Algorithm 1 has
it. `test_jax_reference_stops_the_gradient_at_every_binary_conv` shows the
difference; every other comparison runs the JAX side with a test-local
straight-through sign monkeypatched into `repro.kernels.ref.sign_pm1`
(forward values unchanged; no file of the JAX package is edited).

Tolerances. Forward values of a binary GEMM are exact integers: held
exactly. Scores, BN states, losses, gradients and optimizer moments are
float32 sums taken in other orders by XLA and torch: held to 1e-5 relative
to the largest magnitude of each tensor (REL); BN counts and step counts
exactly. One exception, measured: in the CNN's float-activation modes ('bc',
'float') the gradients and the moments made from them are held to 5e-5
(REL_FLOAT_CNN). There the reference's own float32 gradients lie up to
~2e-5 from a float64 evaluation of the same net on the same inputs and
draws, farther than the port's
(`test_cnn_float_mode_gap_is_the_references_float32_rounding` holds both,
`-s` prints them): the gap is float32 rounding in the reference, not a
difference of function.

Params after a step. S-AdaMax divides each moment by its own AP2-rounded
scale, update = -s * m * AP2(1 / (u + eps)), so on the first step a param
moves by about s / 10 however small its gradient. A gradient element that
is 0 up to rounding (a sum that cancels; 1e-8 against a tensor maximum of
2.4 here) gets its sign and size from the rounding of its sum, and the
normalization turns that into a whole update in either direction. So a
param is held to JAX's at REL, or, where it is not, the element must be one
of: (a) an AP2 boundary, AP2(1 / (u + eps)) rounding to another power of
two in the two packages (each package's own exponent, as its optimizer took
it) from second moments u that agree at the moments' tolerance; (b) a
noise-floor gradient, its first moment within the moments' tolerance of 0
in both packages (|m|, |m_jax| <= rel * max|m_jax| of its tensor); (c) the
moment difference carried through a shared AP2 factor A: |p - p_jax| <=
s * |m - m_jax| * A, with m and m_jax held at the moments' tolerance (a
gradient element of small magnitude carries the absolute rounding of its
tensor as a large relative error, and the update keeps that relative
error). The counts of each are printed (`-s`); no other element may differ,
and no element is absorbed by a wider tolerance.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_rel, jax_to_np, np_cnn, np_leaves, np_mlp,
    np_to_jax, quantized, to_port,
)
from repro.core.ap2 import ap2_exponent as j_ap2_exponent
from repro.data.synthetic import ImageDataConfig as JImageDataConfig
from repro.data.synthetic import SyntheticImages as JSyntheticImages
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.binary_gemm import binary_gemm_mxu as j_binary_gemm_mxu
from repro.models import paper_nets as jpn
from repro.optim.base import apply_updates as j_apply_updates
from repro_torch.configs.bnn_paper import BNN_CIFAR10, BNN_MNIST
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core import ap2 as tap2
from repro_torch.data.synthetic import ImageDataConfig, SyntheticImages
from repro_torch.kernels import binary_gemm as tbg
from repro_torch.kernels import ops as tops
from repro_torch.models import paper_nets as tpn
from repro_torch.optim.base import tree_leaves, tree_map, tree_unflatten_like
from repro_torch.train import paper as tp

jsa = importlib.import_module("repro.optim.shift_adamax")

CNN = dict(widths=(8, 8, 16, 16, 32, 32), fc=32, img=8)
MLP = dict(in_dim=64, hidden=32)
BATCH = {"cnn": 4, "mlp": 8}
CFG = {"cnn": dataclasses.replace(BNN_CIFAR10, widths=CNN["widths"],
                                  fc=CNN["fc"], img=CNN["img"],
                                  batch=BATCH["cnn"]),
       "mlp": dataclasses.replace(BNN_MNIST, in_dim=MLP["in_dim"],
                                  hidden=MLP["hidden"], batch=BATCH["mlp"])}
MODES = ["bbp", "bc", "float"]
SEED_KEY = 21
REL, REL_FLOAT_CNN = 1e-5, 5e-5
LR = 2 ** -6                    # bnn-cifar10 / bnn-mnist base_lr
# S-AdaMax's first-step scale s = AP2(lr / (1 - b1)), b1 = 0.9 in float32
FIRST_SCALE = 2.0 ** np.round(np.log2(np.float32(LR) / (1 - np.float32(0.9))))


def _grad_rel(net, mode):
    return REL_FLOAT_CNN if (net == "cnn" and mode != "bbp") else REL


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------
@jax.custom_vjp
def _ste_sign(x):
    return jnp.where(x >= 0, 1.0, -1.0).astype(jnp.float32)


_ste_sign.defvjp(lambda x: (_ste_sign(x), x),
                 lambda x, g: (g * (jnp.abs(x) <= 1.0).astype(g.dtype),))


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))


def jax_noise(net, key, params, batch, mode):
    """JAX's draws by the port's site names (`models.paper_nets`), from the
    key chain of the JAX forwards."""
    noise, split = {}, jax.random.split
    if net == "mlp":
        n = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            din, dout = lp["w"].shape
            kk = jax.random.fold_in(key, i)
            kw, ka = split(kk)
            qm = "bc" if (mode == "bbp" and i == 0) else mode
            if qm == "bbp":
                noise[f"layers.{i}.qact"] = _uniform(ka, (batch, din))
            if qm in ("bbp", "bc"):
                noise[f"layers.{i}.w"] = _uniform(kw, (din, dout))
            if mode == "bbp" and i < n - 1:
                noise[f"layers.{i}.act"] = _uniform(jax.random.fold_in(kk, 7),
                                                    (batch, dout))
        return noise
    side, cin = CNN["img"], 3
    for i, cp in enumerate(params["convs"]):
        kk = jax.random.fold_in(key, i)
        if mode == "bbp":
            noise[f"convs.{i}.w"] = _uniform(kk, cp["w"].shape)
            if i > 0:
                noise[f"convs.{i}.act"] = _uniform(
                    jax.random.fold_in(kk, 3), (batch, side, side, cin))
        cin = cp["w"].shape[-1]
        if i % 2 == 1:
            side //= 2
    for j, name in enumerate(("fc1", "fc2")):
        kk = jax.random.fold_in(key, 100 + j)
        kw, ka = split(kk)
        din, dout = params[name]["w"].shape
        if mode == "bbp":
            noise[f"{name}.act"] = _uniform(jax.random.fold_in(kk, 5),
                                            (batch, din))
            noise[f"{name}.qact"] = _uniform(ka, (batch, din))
        if mode in ("bbp", "bc"):
            noise[f"{name}.w"] = _uniform(kw, (din, dout))
    kw, ka = split(jax.random.fold_in(key, 999))
    if mode == "bbp":
        noise["out.qact"] = _uniform(ka, (batch, CNN["fc"]))
    if mode in ("bbp", "bc"):
        noise["out.w"] = _uniform(kw, params["out"]["w"].shape)
    return noise


def _jax_step_fn(net, mode):
    opt = jsa.shift_adamax(jsa.shift_lr_schedule(LR, 50))

    def step(params, bn, st, x, y, key):
        def loss_fn(p):
            if net == "mlp":
                s, nb = jpn.mlp_forward(p, x, mode=mode, train=True, key=key), bn
            else:
                s, nb = jpn.cnn_forward(p, bn, x, mode=mode, train=True,
                                        key=key, bn_kind="shift",
                                        kernel_path="ref")
            return jpn.square_hinge_loss(s, y), (nb, s)

        (loss, (nb, s)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        up, st2 = opt.update(g, st, params)
        new = jpn.clip_all_weights(j_apply_updates(params, up))
        return {"params": new, "bn": nb, "opt": st2, "loss": loss,
                "grads": g, "scores": s}

    return jax.jit(step)


def _inputs(net):
    """numpy (params, bn_state, opt_state, x, y) of one small net."""
    rng = np.random.default_rng(3 if net == "cnn" else 4)
    if net == "cnn":
        params, bn = np_cnn(rng, **CNN)
        x = quantized(rng, (BATCH["cnn"], CNN["img"], CNN["img"], 3))
    else:
        params, bn = np_mlp(rng, MLP["in_dim"], MLP["hidden"]), None
        x = quantized(rng, (BATCH["mlp"], MLP["in_dim"]))
    y = rng.integers(0, 10, x.shape[0]).astype(np.int32)
    opt = jax_to_np(jsa.shift_adamax(0.1).init(np_to_jax(params)))
    return params, bn, opt, x, y


def _run_jax(net, mode, draws, *, ste):
    params, bn, opt, x, y = _inputs(net)
    key = jax.random.PRNGKey(SEED_KEY) if draws else None
    jbn = None if bn is None else np_to_jax(bn)
    with pytest.MonkeyPatch.context() as mp:
        if ste:         # the jitted step is traced here, with the patch
            mp.setattr(jref, "sign_pm1", _ste_sign)
        out = _jax_step_fn(net, mode)(np_to_jax(params), jbn, np_to_jax(opt),
                                      jnp.asarray(x), jnp.asarray(y), key)
    bn_out = out.pop("bn")
    res = jax_to_np(out)
    res["bn"] = None if bn_out is None else jax_to_np(bn_out)
    res["noise"] = jax_noise(net, key, params, x.shape[0], mode) if draws \
        else None
    return res


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's step results by (net, mode, draws), computed once."""
    cache = {}

    def get(net, mode, draws, ste=True):
        k = (net, mode, draws, ste)
        if k not in cache:
            cache[k] = _run_jax(net, mode, draws, ste=ste)
        return cache[k]

    return get


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------
def _port_forward(net, params, bn, x, mode, noise, path, gen=None):
    if net == "mlp":
        return tpn.mlp_forward(params, x, mode=mode, train=True, gen=gen,
                               noise=noise, kernel_path=path), bn
    return tpn.cnn_forward(params, bn, x, mode=mode, train=True, gen=gen,
                           noise=noise, bn_kind="shift", kernel_path=path)


def _port_grads(net, mode, noise, path="auto"):
    """(scores, new bn, loss, grads) of the port at the JAX inputs."""
    params, bn, _, x, y = _inputs(net)
    tparams = to_port(params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    masters = tree_unflatten_like(tparams, leaves)
    noise_t = None if noise is None else {k: _t(v) for k, v in noise.items()}
    scores, nb = _port_forward(net, masters, None if bn is None else to_port(bn),
                               _t(x), mode, noise_t, path)
    loss = tpn.square_hinge_loss(scores, _t(y))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (scores.detach().numpy(), None if nb is None else to_numpy_tree(nb),
            float(loss), to_numpy_tree(tree_unflatten_like(tparams, grads)))


def _port_step(net, mode, noise, path="auto"):
    params, bn, opt, x, y = _inputs(net)
    cfg = CFG[net]
    step = tp.make_train_step(cfg, tp.make_optimizer(cfg), mode=mode,
                              bn_kind="shift", kernel_path=path)
    noise_t = None if noise is None else {k: _t(v) for k, v in noise.items()}
    out = step(to_port(params), None if bn is None else to_port(bn),
               from_numpy_tree(opt, device="cpu"), _t(x), _t(y), None,
               noise=noise_t)
    return out


def _leaves_close(got, want, what, rel=REL):
    for i, (b, a) in enumerate(zip(np_leaves(got), np_leaves(want),
                                   strict=True)):
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=f"{what} leaf {i}")
        else:
            assert_rel(b, a, rel=rel, what=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# binary_matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(9, 100, 48), (3, 37, 33), (40, 33, 7)])
def test_binary_matmul_routes_and_ste_backward_match_jax(m, k, n):
    rng = np.random.default_rng(m * k)
    x = rng.uniform(-1.5, 1.5, (m, k)).astype(np.float32)
    x.reshape(-1)[::11] = 0.0
    w = rng.uniform(-1.5, 1.5, (k, n)).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jops.binary_matmul(a, b, "ref"),
                        jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    for path in tops.MATMUL_PATHS:
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        out = tops.binary_matmul(xt, wt, path)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
        out.backward(_t(g))
        assert_rel(xt.grad.numpy(), np.asarray(jgx), what=f"{path} grad x")
        assert_rel(wt.grad.numpy(), np.asarray(jgw), what=f"{path} grad w")
    np.testing.assert_array_equal(
        tops.binary_matmul_vpu(_t(x), _t(w)).numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tops.binary_matmul_mxu(_t(x), _t(w)).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="path"):
        tops.binary_matmul(_t(x), _t(w), "pallas")


def test_mxu_plain_matches_the_pallas_kernel_in_interpret_mode():
    # K = 600 is not a multiple of the TPU kernel's bk = 512: its +1 pad of
    # K and the subtraction of the pad count are exercised
    rng = np.random.default_rng(8)
    x = rng.normal(size=(20, 600)).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    w = rng.normal(size=(600, 30)).astype(np.float32)
    want = np.asarray(j_binary_gemm_mxu(jnp.asarray(x), jnp.asarray(w),
                                        interpret=True))
    np.testing.assert_array_equal(tbg.binary_gemm_mxu_plain(_t(x), _t(w)).numpy(),
                                  want)
    tbg.reset_launches()
    np.testing.assert_array_equal(tbg.binary_gemm_mxu(_t(x), _t(w)).numpy(), want)
    xb = _t(x).to(torch.bfloat16)
    np.testing.assert_array_equal(tbg.binary_gemm_mxu(xb, _t(w)).numpy(), want)
    assert tbg.launches["binary_gemm_mxu"] == 0       # CPU: the plain version


def test_binary_gemm_mxu_rejects_bad_operands():
    x, w = torch.zeros(4, 6), torch.zeros(6, 3)
    for bad in ((x.double(), w), (x, w.to(torch.bfloat16)), (x, w[:5]),
                (x.t(), torch.zeros(4, 3)), (x[None], w)):
        with pytest.raises(ValueError):
            tbg.binary_gemm_mxu(*bad)


# ---------------------------------------------------------------------------
# The reference defect
# ---------------------------------------------------------------------------
def test_jax_reference_stops_the_gradient_at_every_binary_conv(jax_refs):
    plain = jax_refs("cnn", "bbp", False, ste=False)
    _, _, _, port = _port_grads("cnn", "bbp", None)
    for i in range(6):
        jg = plain["grads"]["convs"][i]["w"]
        tg = port["convs"][i]["w"]
        if i < 5:       # convs 1-5: each feeds a binary conv
            assert not jg.any(), f"JAX conv {i + 1} got a gradient"
            assert not plain["grads"]["convs"][i]["bn"]["beta"].any()
        else:           # conv 6 feeds fc1 through binary_act's STE
            assert jg.any()
        assert tg.any(), f"the port's conv {i + 1} got no gradient"
    # the straight-through sign changes no forward value: the same scores
    patched = jax_refs("cnn", "bbp", False)
    np.testing.assert_array_equal(patched["scores"], plain["scores"])


# ---------------------------------------------------------------------------
# The slice: train forwards, gradients, one whole step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("draws", [False, True], ids=["det", "jax_draws"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("net", ["mlp", "cnn"])
def test_train_forward_and_gradients_match_jax(jax_refs, net, mode, draws):
    ref = jax_refs(net, mode, draws)
    scores, nb, loss, grads = _port_grads(net, mode, ref["noise"])
    assert_rel(scores, ref["scores"], what="scores")
    assert loss == pytest.approx(float(ref["loss"]), rel=1e-5, abs=0)
    if net == "cnn":
        _leaves_close(nb, ref["bn"], "bn state")
        assert all(int(s["count"]) == 1 for s in nb["convs"])
    _leaves_close(grads, ref["grads"], "grads", _grad_rel(net, mode))
    if net == "cnn" and mode != "float":
        # every conv's weight has a gradient (Algorithm 1's STE)
        assert all(np.abs(g["w"]).max() > 0 for g in grads["convs"])


def _check_step(out, ref, rel_moments):
    """The module doc's checks of one step; returns the counts of elements
    explained by (a), (b) and (c)."""
    params, bn, st, loss = out
    assert float(loss) == pytest.approx(float(ref["loss"]), rel=REL, abs=0)
    got_st = to_numpy_tree(st)
    assert int(got_st["step"]) == int(ref["opt"]["step"]) == 1
    _leaves_close(got_st["m"], ref["opt"]["m"], "opt m", rel_moments)
    _leaves_close(got_st["u"], ref["opt"]["u"], "opt u", rel_moments)
    if bn is not None:
        _leaves_close(to_numpy_tree(bn), ref["bn"], "bn state")
    got_p = np_leaves(to_numpy_tree(params))
    jm, tm = np_leaves(ref["opt"]["m"]), np_leaves(got_st["m"])
    ju, tu = np_leaves(ref["opt"]["u"]), np_leaves(got_st["u"])
    explained = {"ap2": 0, "noise_floor": 0, "carried": 0}
    for i, (b, a) in enumerate(zip(got_p, np_leaves(ref["params"]),
                                   strict=True)):
        diff = np.abs(b.astype(np.float64) - a)
        off = diff > REL * np.abs(a).max()
        if not off.any():
            continue
        # each package's AP2 exponent of 1 / (u + eps), as its optimizer
        # took it (float32, its own log2)
        e_j = np.asarray(j_ap2_exponent(1.0 / (jnp.asarray(ju[i]) + 1e-8)))[off]
        e_t = tap2.ap2_exponent(1.0 / (_t(tu[i]) + 1e-8)).numpy()[off]
        floor = rel_moments * np.abs(jm[i]).max()
        noise = (np.abs(jm[i][off]) <= floor) & (np.abs(tm[i][off]) <= floor)
        # u itself is held at the moments' tolerance above
        straddle = ~noise & (e_j != e_t)
        dm = np.abs(tm[i][off].astype(np.float64) - jm[i][off])
        carried = ~noise & (e_j == e_t) & (
            diff[off] <= FIRST_SCALE * dm * 2.0 ** e_j * (1 + 1e-6)
            + REL * np.abs(a).max())
        bad = ~(noise | straddle | carried)
        assert not bad.any(), (f"param leaf {i}: {int(bad.sum())} elements "
                               f"differ beyond REL and are none of (a)-(c)")
        explained["noise_floor"] += int(noise.sum())
        explained["ap2"] += int(straddle.sum())
        explained["carried"] += int(carried.sum())
    return explained


@pytest.mark.parametrize("draws", [False, True], ids=["det", "jax_draws"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("net", ["mlp", "cnn"])
def test_one_train_step_matches_jax(jax_refs, net, mode, draws):
    ref = jax_refs(net, mode, draws)
    explained = _check_step(_port_step(net, mode, ref["noise"]), ref,
                            _grad_rel(net, mode))
    print(f"{net} {mode} {'jax_draws' if draws else 'det'}: params outside "
          f"REL, explained: {explained}")


def _port_grads_f64(mode, noise):
    """The port's CNN gradients in float64 (the float-activation modes run
    no float32-only op), with the square hinge loss written out in float64,
    as sorted numpy leaves."""
    params, bn, _, x, y = _inputs("cnn")
    f64 = (lambda a: a.double() if a.is_floating_point() else a)
    tparams = tree_map(f64, to_port(params))
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    scores, _ = tpn.cnn_forward(
        tree_unflatten_like(tparams, leaves), tree_map(f64, to_port(bn)),
        _t(x).double(), mode=mode, train=True,
        noise={k: _t(v).double() for k, v in noise.items()}, kernel_path="ref")
    t = 2.0 * torch.nn.functional.one_hot(_t(y).long(), 10).double() - 1.0
    loss = (torch.clamp(1.0 - t * scores, min=0.0) ** 2).sum(-1).mean()
    grads = torch.autograd.grad(loss, leaves)
    return np_leaves(to_numpy_tree(tree_unflatten_like(tparams, grads)))


@pytest.mark.parametrize("mode", ["bc", "float"])
def test_cnn_float_mode_gap_is_the_references_float32_rounding(jax_refs,
                                                               mode):
    """Why REL_FLOAT_CNN: against a float64 evaluation of the same net, the
    port's float32 gradients are at least as close as the reference's, and
    the reference's are within REL_FLOAT_CNN."""
    ref = jax_refs("cnn", mode, True)
    exact = _port_grads_f64(mode, ref["noise"])
    port = np_leaves(_port_grads("cnn", mode, ref["noise"])[3])

    def worst(grads):
        return max(np.abs(g - e).max() / np.abs(e).max()
                   for g, e in zip(grads, exact, strict=True) if np.abs(e).max())

    jax_err, port_err = worst(np_leaves(ref["grads"])), worst(port)
    print(f"cnn {mode}: largest gradient error relative to float64: JAX "
          f"{jax_err:.3g}, port {port_err:.3g}")
    assert port_err <= jax_err <= REL_FLOAT_CNN


def test_kernel_paths_give_identical_steps_on_the_cpu(jax_refs):
    noise = jax_refs("cnn", "bbp", True)["noise"]
    outs = {path: _port_step("cnn", "bbp", noise, path)
            for path in tops.MATMUL_PATHS}
    base = outs["auto"]
    for path, out in outs.items():
        for a, b in zip(tree_leaves(base), tree_leaves(out), strict=True):
            assert torch.equal(a, b), path


def test_train_step_draws_from_the_generator():
    net, mode = "cnn", "bbp"
    params, bn, opt, x, y = _inputs(net)
    cfg = CFG[net]
    step = tp.make_train_step(cfg, tp.make_optimizer(cfg), kernel_path="ref")
    args = (to_port(params), to_port(bn), from_numpy_tree(opt, device="cpu"),
            _t(x), _t(y))
    a = step(*args, torch.Generator().manual_seed(2))
    b = step(*args, torch.Generator().manual_seed(2))
    c = step(*args, torch.Generator().manual_seed(3))
    d = step(*args, None)
    assert float(a[3]) == float(b[3])
    assert len({float(a[3]), float(c[3]), float(d[3])}) == 3


def test_frozen_weights_refuse_training():
    rng = np.random.default_rng(9)
    params, bn = np_cnn(rng, **CNN)
    x = _t(quantized(rng, (2, CNN["img"], CNN["img"], 3)))
    frozen = tpn.freeze_cnn(to_port(params), to_port(bn))
    with pytest.raises(ValueError, match="inference only"):
        tpn.cnn_forward(frozen, to_port(bn), x, train=True)
    mlp = tpn.freeze_mlp(to_port(np_mlp(rng, 64, 32)))
    with pytest.raises(ValueError, match="inference only"):
        tpn.mlp_forward(mlp, _t(quantized(rng, (2, 64))), train=True)


def test_clip_all_weights_matches_jax():
    rng = np.random.default_rng(10)
    params, _ = np_cnn(rng, **CNN)
    scaled = jax_to_np(jax.tree.map(lambda a: a * 3, np_to_jax(params)))
    want = jax_to_np(jpn.clip_all_weights(np_to_jax(scaled)))
    got = to_numpy_tree(tpn.clip_all_weights(to_port(scaled)))
    for a, b in zip(np_leaves(want), np_leaves(got), strict=True):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("flat", [False, True])
def test_synthetic_images_match_jax(flat):
    jd = JSyntheticImages(JImageDataConfig(img=8, channels=3, noise=0.35,
                                           seed=5), flat=flat)
    td = SyntheticImages(ImageDataConfig(img=8, channels=3, noise=0.35,
                                         seed=5), flat=flat)
    for step in (0, 1, 17):
        for a, b in zip(jd.batch(step, 6), td.batch(step, 6)):
            np.testing.assert_array_equal(b, a)


def test_thirty_cpu_steps_lower_the_mlp_loss():
    losses = tp.train(CFG["mlp"], 30, seed=0, device="cpu")
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_trainer_entry_point_runs_on_the_cpu(capsys):
    assert tp.main(["--config", "bnn-cifar10", "--steps", "2", "--device",
                    "cpu", "--batch", "2", "--widths", "4,4,8,8,8,8",
                    "--fc", "16"]) == 0
    out = capsys.readouterr().out
    assert "step    1" in out and "on cpu" in out
