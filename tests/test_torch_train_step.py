"""passion_tpu_torch's train step, optimizer and schedule against
passion_tpu's, float32 on the CPU (`compute_dtype=None`, dropout off), at
the fast-tier widths (basic_dims 4, trans_dim 32, mlp_dim 64, heads 4) and
patch 32 (at 16 the one-voxel bottleneck's InstanceNorm hides the
transformers, test_torch_train_losses.py):

  * the optimizer, update by update, against `make_optimizer` (optax) on
    the probe gradients of ROADMAP.md fault F1, at 1e-7;
  * one step's gradients, per tensor within 1e-3 of its largest |g|, or
    within twice what JAX's own gradient moves when the input moves by
    1e-6 of itself, where that is more (see the test);
  * three steps' metrics with warmup on and off, one step holding a
    unimodal sample (the NaN preference gate);
  * a padded row (valid = 0) counts in nothing;
  * `lr_at_epoch` in all modes and `update_imb_beta`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from passion_tpu.engine import schedule as jsched
from passion_tpu.engine import train_loop as jloop
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch.engine import schedule as tsched
from passion_tpu_torch.engine import train_loop as tloop
from passion_tpu_torch.interop.jax_weights import mmformer_from_jax_params
from passion_tpu_torch.models import get_model

torch.set_num_threads(2)
PATCH = 32
KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)
FULL, PART, PART2, UNI = ([1, 1, 1, 1], [1, 0, 1, 0], [0, 1, 1, 1],
                          [0, 0, 0, 1])
STEP_MASKS = ([FULL, PART, PART2], [FULL, UNI, PART], [PART2, FULL, PART])
BETA = np.array([1.2, 0.8, 1.0, 0.9], np.float32)
MODAL_W = np.array([1.0, 1.5, 2.0, 3.0], np.float32)


def _batch(masks, seed):
    rng = np.random.default_rng(seed)
    b = len(masks)
    x = rng.standard_normal((b, PATCH, PATCH, PATCH, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (b, PATCH, PATCH, PATCH))
    target = np.eye(4, dtype=np.float32)[labels]
    return dict(x=x, target=target, mask=np.asarray(masks, bool))


def _port_batch(batch):
    def cf(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    out = dict(x=cf(batch["x"]), target=cf(batch["target"]),
               mask=torch.from_numpy(batch["mask"]))
    if "valid" in batch:
        out["valid"] = torch.from_numpy(batch["valid"])
    return out


@pytest.fixture(scope="module")
def jax_model():
    jm = jax_get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     batch_size=3, scale=0.3))
    return jm, params


def _port_model(params):
    tm = get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)
    return tm


def _grab_grads():
    """An optax transformation whose state is the last gradient and whose
    update is zero: the JAX step then hands back its exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


# --- optimizer (fault F1) --------------------------------------------------

def _optax_trajectory(p0, grads, lr, wd):
    tx = jsched.make_optimizer(wd)
    state = tx.init(p0)
    state = jsched.set_learning_rate(state, lr)
    p, out = jnp.asarray(p0), []
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = p + upd
        out.append(np.asarray(p))
    return out


def _port_trajectory(p0, grads, lr, wd):
    p = torch.nn.Parameter(torch.from_numpy(np.array(p0)))
    opt = tsched.make_optimizer([p], wd)
    tsched.set_learning_rate(opt, lr)
    out = []
    for g in grads:
        p.grad = torch.from_numpy(np.array(g))
        opt.step()
        out.append(p.detach().numpy().copy())
    return out


def test_optimizer_follows_optax_on_the_f1_probe():
    p0 = np.zeros(2, np.float32)
    grads = [np.array(g, np.float32) for g in ([1, .5], [0, .5], [.1, .5])]
    ref = _optax_trajectory(p0, grads, 2e-4, 1e-4)
    got = _port_trajectory(p0, grads, 2e-4, 1e-4)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, atol=1e-7, rtol=0)
    # the displacement of the shrinking coordinate at step 2 (ROADMAP.md D)
    assert abs(got[1][0] - (-2.948e-4)) < 1e-7
    # torch's own AMSGrad keeps the max of the raw moment and drifts
    p = torch.nn.Parameter(torch.zeros(2))
    adamw = torch.optim.AdamW([p], lr=2e-4, weight_decay=1e-4, amsgrad=True)
    for g in grads[:2]:
        p.grad = torch.from_numpy(g)
        adamw.step()
    assert abs(p[0].item() - got[1][0]) > 3e-5


def test_optimizer_follows_optax_on_random_updates():
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((3, 7)).astype(np.float32)
    grads = [(rng.standard_normal((3, 7)) * s).astype(np.float32)
             for s in (1.0, 0.1, 2.0, 0.01, 0.5)]
    ref = _optax_trajectory(p0, grads, 1e-3, 1e-4)
    got = _port_trajectory(p0, grads, 1e-3, 1e-4)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, atol=1e-7, rtol=0)


def test_optimizer_state_round_trips(tmp_path):
    """A resumed optimizer continues exactly where the saved one was."""
    rng = np.random.default_rng(9)
    grads = [rng.standard_normal(4).astype(np.float32) for _ in range(4)]
    full = _port_trajectory(np.ones(4, np.float32), grads, 1e-2, 1e-4)
    p = torch.nn.Parameter(torch.ones(4))
    opt = tsched.make_optimizer([p])
    tsched.set_learning_rate(opt, 1e-2)
    for g in grads[:2]:
        p.grad = torch.from_numpy(g)
        opt.step()
    torch.save({"p": p.detach(), "opt": opt.state_dict()}, tmp_path / "s.pt")
    saved = torch.load(tmp_path / "s.pt", weights_only=True)
    q = torch.nn.Parameter(saved["p"].clone())
    opt2 = tsched.make_optimizer([q])
    opt2.load_state_dict(saved["opt"])
    for g in grads[2:]:
        q.grad = torch.from_numpy(g)
        opt2.step()
    np.testing.assert_array_equal(q.detach().numpy(), full[-1])


# --- the step against JAX --------------------------------------------------

def test_one_step_gradients_match_jax(jax_model):
    """Gradients of one step against JAX's, per tensor, in relative L2:
    |g_port - g_jax| <= 1e-3 |g_jax|, or three times JAX's own gap where
    the problem defines the gradient less well than that.

    Why the second bound: a norm row of a few voxels (the 2^3 bottleneck at
    patch 32) is nearly constant, so LeakyReLU branches and the losses'
    clamps flip with float32 rounding and the gradients behind them jump;
    JAX's own gradient moves by up to ~0.5% when the input moves by 1e-6 of
    itself (and by ~0.3% for 1e-12 with the network in float64). So the
    bound there is three times the larger gap between JAX's gradient and
    JAX's gradient of the perturbed input, over two draws of the noise. A
    floor of 1e-6 of the largest tensor norm covers the biases that feed a
    norm, whose true gradient is zero.
    """
    jm, params = jax_model
    batch = _batch(STEP_MASKS[0], 11)
    tx = _grab_grads()
    step = jloop.make_train_step(jm, tx, True, with_dropout=False,
                                 compute_dtype=None)

    def jax_grads(b):
        _, grads, metrics = step(params, tx.init(params), b,
                                 jnp.asarray(BETA), jnp.asarray(MODAL_W),
                                 jnp.float32(4.0), jax.random.PRNGKey(0),
                                 False)
        sd = mmformer_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             grads))
        return {k: v.numpy().astype(np.float64) for k, v in sd.items()}, \
            metrics

    ref, ref_m = jax_grads(batch)
    rng = np.random.default_rng(0)
    own = {k: 0.0 for k in ref}
    for _ in range(2):
        noise = rng.standard_normal(batch["x"].shape)
        moved, _ = jax_grads(dict(batch, x=(batch["x"] * (1 + 1e-6 * noise))
                                  .astype(np.float32)))
        for k in own:
            own[k] = max(own[k], np.linalg.norm(moved[k] - ref[k]))

    tm = _port_model(params)
    opt = tsched.make_optimizer(tm.parameters(), 0.0)  # lr 0: no update
    tstep = tloop.make_train_step(tm, opt, True, compute_dtype=None)
    m = tstep(_port_batch(batch), torch.from_numpy(BETA),
              torch.from_numpy(MODAL_W), 4.0)
    np.testing.assert_allclose(m["loss"].item(), float(ref_m["loss"]),
                               rtol=1e-5)
    floor = 1e-6 * max(np.linalg.norm(v) for v in ref.values())
    strict = 0
    for name, p in tm.named_parameters():
        want = ref[name]
        gap = np.linalg.norm(p.grad.numpy() - want)
        bound = 1e-3 * np.linalg.norm(want)
        strict += gap <= bound
        assert gap <= max(bound, 3 * own[name], floor), (
            name, gap / np.linalg.norm(want), own[name] / np.linalg.norm(want))
    # most tensors are held at 1e-3, and the transformers get a gradient
    assert strict >= len(ref) // 2, (strict, len(ref))
    assert np.abs(ref["intra_transformers.0.layers.0.ffn.fc1.weight"]).max() > 0


def _compare_metrics(got, ref, rtol):
    """Metrics of one step; returns whether a preference gate flipped,
    which the knife-edge rule allows only where both sides' rp_iter lie
    within 0.05 of zero."""
    for k in tloop.SCALARS + tloop.VECTORS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)
    g_rp, r_rp = got["rp_iter"].numpy(), np.asarray(ref["rp_iter"])
    np.testing.assert_array_equal(np.isnan(g_rp), np.isnan(r_rp))
    ok = ~np.isnan(r_rp)
    flip = ok & ((g_rp > 0) != (r_rp > 0))
    assert not (flip & ((np.abs(g_rp) > 0.05) | (np.abs(r_rp) > 0.05))).any()
    np.testing.assert_allclose(g_rp[ok], r_rp[ok], rtol=1e-3, atol=1e-4)
    return bool(flip.any())


@pytest.mark.parametrize("warmup", [False, True], ids=["main", "warmup"])
def test_three_steps_match_jax(jax_model, warmup):
    """Three steps at the reference's learning rate (2e-4): every metric of
    every step against JAX's, the second step's batch holding a unimodal
    sample. The first step's metrics come from the shared weights (rtol
    1e-4); later ones from weights each side updated, where AMSGrad's
    normalised step turns the rounding-level gradients of the gradient
    test into parameter gaps of up to 2 lr, so they are held at 1e-3."""
    jm, params = jax_model
    lr = 2e-4
    tx = jsched.make_optimizer(1e-4)
    jstate = jsched.set_learning_rate(tx.init(params), lr)
    jstep = jloop.make_train_step(jm, tx, True, with_dropout=False,
                                  compute_dtype=None)
    tm = _port_model(params)
    opt = tsched.make_optimizer(tm.parameters(), 1e-4)
    tsched.set_learning_rate(opt, lr)
    tstep = tloop.make_train_step(tm, opt, True, compute_dtype=None)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for i, masks in enumerate(STEP_MASKS):
        batch = _batch(masks, 20 + i)
        jparams, jstate, ref = jstep(jparams, jstate, batch,
                                     jnp.asarray(BETA), jnp.asarray(MODAL_W),
                                     jnp.float32(4.0), jax.random.PRNGKey(0),
                                     warmup)
        got = tstep(_port_batch(batch), torch.from_numpy(BETA),
                    torch.from_numpy(MODAL_W), 4.0, warmup=warmup)
        flipped = _compare_metrics(got, ref, 1e-4 if i == 0 else 1e-3)
        if UNI in masks:  # the unimodal sample closes every gate
            assert np.isnan(got["rp_iter"].numpy()).all()
        else:
            assert not np.isnan(got["rp_iter"].numpy()).any()
        if flipped:  # past a knife-edge flip the two runs may part ways
            break


# --- port-only step properties ----------------------------------------------

def _small_model(seed=0):
    from passion_tpu_torch.models import init_model

    return init_model(get_model("mmformer", mask_type="idt", patch_size=16,
                                **KW), seed=seed)


def _small_batch(masks, seed, patch=16):
    rng = np.random.default_rng(seed)
    b = len(masks)
    labels = rng.integers(0, 4, (b, patch, patch, patch))
    return dict(
        x=torch.from_numpy(rng.standard_normal(
            (b, 4, patch, patch, patch)).astype(np.float32)),
        target=torch.from_numpy(np.moveaxis(
            np.eye(4, dtype=np.float32)[labels], -1, 1).copy()),
        mask=torch.tensor(masks, dtype=torch.bool))


def _one_step(batch, seed=0):
    tm = _small_model(seed)
    opt = tsched.make_optimizer(tm.parameters(), 1e-4)
    tsched.set_learning_rate(opt, 1e-3)
    step = tloop.make_train_step(tm, opt, True, compute_dtype=None)
    m = step(batch, torch.from_numpy(BETA), torch.from_numpy(MODAL_W), 4.0)
    return m, tm


def test_padded_row_counts_in_nothing():
    """A batch of two real rows plus a copy of row 0 marked valid = 0
    gives the metrics and the update of the two real rows alone."""
    real = _small_batch([FULL, PART], 3)
    padded = {k: torch.cat([v, v[:1]]) for k, v in real.items()}
    padded["valid"] = torch.tensor([1.0, 1.0, 0.0])
    m_real, net_real = _one_step(real)
    m_pad, net_pad = _one_step(padded)
    for k in tloop.SCALARS + tloop.VECTORS + ("rp_iter",):
        torch.testing.assert_close(m_pad[k], m_real[k], rtol=1e-5,
                                   atol=1e-6, msg=k)
    for (name, a), b in zip(net_real.named_parameters(),
                            net_pad.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)


def test_unimodal_sample_closes_the_gate():
    """An IDT sample with one modality gives an all-zero dist row, a NaN
    rp_iter for every modality, and so no rp-gated loss this iteration."""
    m, _ = _one_step(_small_batch([FULL, UNI], 4))
    assert torch.isnan(m["rp_iter"]).all()
    assert torch.isfinite(m["loss"])
    # rp_mask all False: the loss is fuse + prm + 0.5 kl exactly
    np.testing.assert_allclose(
        m["loss"].item(),
        (m["fuse_loss"] + m["prm_loss"] + 0.5 * m["kl_loss"]).item(),
        rtol=1e-6)
    assert m["sep_loss"].item() == 0 and m["proto_loss"].item() == 0


# --- schedule and preference update ------------------------------------------

@pytest.mark.parametrize("mode", ["poly", "warmup", "cousinewarmup",
                                  "warmuppoly"])
def test_lr_at_epoch_matches_jax(mode):
    for warmup in (0, 5, 100):
        for epoch in (0, 1, 7, 99, 100, 150, 199, 200, 250, 299):
            if mode == "warmup" and warmup == 0:
                continue  # the reference divides by warmup there
            want = jsched.lr_at_epoch(epoch, 2e-4, 300, mode, warmup)
            assert tsched.lr_at_epoch(epoch, 2e-4, 300, mode, warmup) == want
    with pytest.raises(ValueError):
        tsched.lr_at_epoch(0, 1.0, 10, "nope")


def test_update_imb_beta_matches_jax():
    rng = np.random.default_rng(2)
    beta, eta = np.ones(4, np.float32), 0.01
    jbeta, jeta = beta.copy(), eta
    for epoch in range(0, 203, 7):
        dist = rng.uniform(0.01, 0.2, 4)
        beta, eta, rp = tloop.update_imb_beta(beta, eta, dist, epoch, 10)
        jbeta, jeta, jrp = jloop.update_imb_beta(jbeta, jeta, dist, epoch, 10)
        np.testing.assert_array_equal(beta, jbeta)
        np.testing.assert_array_equal(rp, jrp)
        assert eta == jeta


def test_ragged_batch_is_padded_with_invalid_rows():
    """`fit` pads a short last batch to the batch size by repeating sample
    0 with valid = 0, so the step keeps one shape."""
    rng = np.random.default_rng(8)
    host = dict(x=rng.standard_normal((1, 4, 2, 2, 2)).astype(np.float32),
                target=np.ones((1, 4, 2, 2, 2), np.float32),
                mask=np.array([UNI], bool), name=["a"])
    dev = tloop._to_device(host, 3, torch.device("cpu"))
    assert dev["x"].shape[0] == 3 and dev["x"].dtype == torch.float32
    torch.testing.assert_close(dev["valid"], torch.tensor([1.0, 0.0, 0.0]))
    for k in ("x", "target", "mask"):
        assert torch.equal(dev[k][2], dev[k][0])
    full = tloop._to_device(host, 1, torch.device("cpu"))
    torch.testing.assert_close(full["valid"], torch.tensor([1.0]))
