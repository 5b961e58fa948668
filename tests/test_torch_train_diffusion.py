"""The port's diffusion training and sampling (speech_enhancement_tpu_torch/
train/diffusion.py) against the JAX package's, on the CPU at fp32, on
converted weights and on JAX's own random draws:

* ``linear_noise_schedule`` equal; ``inference_schedule`` (full and fast)
  within 1e-12, and the same ``ValueError`` outside the reverse process's
  domain;
* ``add_noise`` on JAX's draws (t, noise): float64 rtol 1e-9; float32
  within the formula's own conditioning at small t and relative RMS 1e-5
  from t = 10 on (the test says why);
* one ``diffuse_step`` and one ``tsc_diffusion_step`` (flax dropout off
  through ``no_flax_dropout``, the port's dropout rates 0): loss rtol
  1e-4, all gradients relative RMS < 1e-3 and each leaf < 1e-2 (the fp32
  floor of a whole network's gradients at random init),
  the parameters after one update of the SGD of both packages (Nesterov
  momentum 0.9, weight decay 0.01, lr 1e-3) rtol 1e-3 and the updated
  BatchNorm statistics rtol 1e-5;
* both samplers over the fast schedule on JAX's per-step draws (replayed
  from the sampler's split sequence), ``clamp_every_step`` and a given
  ``conditioner`` included, by both the kernel route (the kernels' plain
  versions on the CPU) and the plain route: relative RMS < 1e-4;
* the bf16 steps: finite, within 5% of the fp32 loss (the bound of the
  JAX package's tests/test_train_diffusion.py), fp32 masters.

Widths: DiffuSE 16 channels, 4 layers, cycle 2; DiffusionTSCNet 8
channels; B, L = 2, 4000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_common import KEEP_GRADS, no_flax_dropout, read_grads, rel_rms  # noqa: F401

from speech_enhancement_tpu.models import DiffuSE as FlaxDiffuSE
from speech_enhancement_tpu.models import DiffusionTSCNet as FlaxDiffusionTSCNet
from speech_enhancement_tpu.ops import compressed_stft as jax_compressed_stft
from speech_enhancement_tpu.train import add_noise as jax_add_noise
from speech_enhancement_tpu.train import build_optimizer as jax_build_optimizer
from speech_enhancement_tpu.train import diffuse_step as jax_diffuse_step
from speech_enhancement_tpu.train import inference_schedule as jax_inference_schedule
from speech_enhancement_tpu.train import l1_loss as jax_l1_loss
from speech_enhancement_tpu.train import linear_noise_schedule as jax_linear_noise_schedule
from speech_enhancement_tpu.train import sample_tsc as jax_sample_tsc
from speech_enhancement_tpu.train import sample_waveform as jax_sample_waveform
from speech_enhancement_tpu.train import tsc_diffusion_step as jax_tsc_diffusion_step
from speech_enhancement_tpu.train.state import ModuleState as JaxModuleState
from speech_enhancement_tpu_torch.models import DiffuSE, DiffusionTSCNet
from speech_enhancement_tpu_torch.train import (
    ModuleState,
    add_noise,
    build_optimizer,
    diffuse_step,
    inference_schedule,
    l1_loss,
    linear_noise_schedule,
    sample_tsc,
    sample_waveform,
    tsc_diffusion_step,
)
from speech_enhancement_tpu_torch.utils.convert import (
    diffuse_state_dict_from_flax,
    tsc_diffusion_state_dict_from_flax,
)

torch.set_num_threads(1)

B, L = 2, 4000
FAST = [0.0001, 0.001, 0.01, 0.05, 0.2, 0.35]
SCHEDULE = linear_noise_schedule(50)


def signals(seed, amplitude=0.1):
    rng = np.random.default_rng(seed)
    clean = (amplitude * rng.standard_normal((B, L))).astype(np.float32)
    noisy = (clean + 0.2 * amplitude * rng.standard_normal((B, L))).astype(np.float32)
    return clean, noisy


def perturbed(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def diffuse_models():
    """The flax DiffuSE (weights perturbed: its output conv starts at zero)
    and the port's on the same weights."""
    model = FlaxDiffuSE(dilation_cycle_length=2, residual_channels=16, residual_layers=4)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, L)),
                           jnp.zeros((1, L // 100, 201)), jnp.array([0]))
    params = perturbed(variables["params"], 1, 0.05)

    def port():
        m = DiffuSE(dilation_cycle_length=2, residual_channels=16, residual_layers=4,
                    device="cpu")
        m.load_state_dict(diffuse_state_dict_from_flax(params), strict=True)
        return m

    return model, params, port


@pytest.fixture(scope="module")
def tsc_models():
    model = FlaxDiffusionTSCNet(num_channel=8, num_features=201, num_steps=50)
    spec = jax_compressed_stft(jnp.zeros((1, L)), 400, 100)
    variables = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                           spec, spec, jnp.array([0]))
    params = perturbed(variables["params"], 2, 0.01)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    def port():
        m = DiffusionTSCNet(8, 201, 50, device="cpu")
        m.load_state_dict(tsc_diffusion_state_dict_from_flax(params, stats), strict=True)
        for mod in m.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        return m

    return model, {"params": params, "batch_stats": stats}, port


def test_linear_noise_schedule_equals_jax():
    np.testing.assert_array_equal(linear_noise_schedule(50), jax_linear_noise_schedule(50))


@pytest.mark.parametrize("fast", [False, True])
def test_inference_schedule_matches_jax(fast):
    got = inference_schedule(SCHEDULE, FAST, fast=fast)
    want = jax_inference_schedule(SCHEDULE, FAST, fast=fast)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape == ((6,) if fast else (50,)), name
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("schedule, fast", [
    (np.linspace(1e-4, 0.05, 20), False),  # too little noise: final alpha_cum >= 0.5
    (np.linspace(1e-4, 0.035, 50), [0.3, 0.5, 0.5]),  # an intermediate step past the clamp
])
def test_inference_schedule_raises_outside_its_domain(schedule, fast):
    for fn in (inference_schedule, jax_inference_schedule):
        with pytest.raises(ValueError, match="alpha_cum"):
            fn(schedule, fast if fast else None, fast=bool(fast))


def jax_noise_draws(key, shape, n_steps, dtype=jnp.float32):
    """The (t, noise) that JAX's ``add_noise`` draws from ``key``."""
    rng_t, rng_n = jax.random.split(key)
    t = jax.random.randint(rng_t, (shape[0],), 0, n_steps)
    return (torch.from_numpy(np.array(t)),
            torch.from_numpy(np.array(jax.random.normal(rng_n, shape, dtype))))


def test_add_noise_matches_jax_on_jax_draws():
    """In float64 the port's result is JAX's to rtol 1e-9: the same formula
    operation for operation.  In float32 the formula cancels where t is
    small: ``d = 1 - (1 + m^2) noise_level`` is about 5e-9 at t = 0, so the
    roundings of its O(1) terms, which JAX and torch may make apart (their
    cumulative products can differ by an ulp), move ``sqrt(d)`` by up to
    ``sqrt(d + k eps) - sqrt(d)``.  So each row of both packages' fp32
    results is held to the exact (float64) value on the same draws within
    that for k = 8 roundings of eps = 2^-24, times the row's largest noise
    draw (over ``sqrt(1 - noise_level)`` for the combined noise), plus 1e-6;
    and, where t >= 10, the port's to JAX's within relative RMS 1e-5."""
    clean, noisy = signals(3)
    clean = np.concatenate([clean] * 8)  # 16 rows: many timesteps
    noisy = np.concatenate([noisy] * 8)
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        want64 = jax_add_noise(jnp.asarray(clean, jnp.float64), jnp.asarray(noisy, jnp.float64),
                               jnp.asarray(SCHEDULE), key)
        t64, noise64 = jax_noise_draws(key, clean.shape, 50, jnp.float64)
    got64 = add_noise(torch.from_numpy(clean).double(), torch.from_numpy(noisy).double(),
                      SCHEDULE, t=t64, noise=noise64)
    np.testing.assert_array_equal(got64[2].numpy(), np.asarray(want64[2]))
    for g, w in zip(got64[:2], want64[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)

    want32 = jax_add_noise(jnp.asarray(clean), jnp.asarray(noisy),
                           jnp.asarray(SCHEDULE, jnp.float32), key)
    t, noise = jax_noise_draws(key, clean.shape, 50)
    got32 = add_noise(torch.from_numpy(clean), torch.from_numpy(noisy), SCHEDULE, t=t, noise=noise)
    np.testing.assert_array_equal(got32[2].numpy(), np.asarray(want32[2]))
    ts = t.numpy()
    assert len(set(ts.tolist())) > 8 and ts.min() < 10 <= ts.max()
    exact = add_noise(torch.from_numpy(clean).double(), torch.from_numpy(noisy).double(),
                      SCHEDULE, t=t, noise=noise.double())
    level = np.cumprod(1.0 - SCHEDULE)[ts]
    d = 1.0 - (1.0 + (1.0 - level) / np.sqrt(level)) * level
    spread = (np.sqrt(d + 8 * 2.0 ** -24) - np.sqrt(d)) * np.abs(noise.numpy()).max(axis=1)
    bounds = (spread + 1e-6, (spread + 1e-6) / np.sqrt(1.0 - level))
    for g, w, x, bound in zip(got32[:2], want32[:2], exact[:2], bounds):
        x, w = x.numpy(), np.asarray(w)
        assert np.all(np.abs(g.numpy() - x).max(axis=1) <= bound)
        assert np.all(np.abs(w - x).max(axis=1) <= bound)
        assert all(rel_rms(g.numpy()[r], w[r]) < 1e-5 for r in np.flatnonzero(ts >= 10))


def test_add_noise_draws_from_its_generator():
    clean, noisy = (torch.from_numpy(a) for a in signals(5))
    runs = [add_noise(clean, noisy, SCHEDULE, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert all(0 <= int(x) < 50 for x in runs[0][2])
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert not torch.equal(runs[0][0], runs[2][0])


def jax_state(params, extra, tx):
    return JaxModuleState(params=params, extra=extra, opt_state=tx.init(params), step=0)


def assert_grads_match(got: dict, want: dict):
    """All gradients together within relative RMS 1e-3, each leaf within
    1e-2: a whole network's fp32 gradients at random init agree to about
    1e-3 per leaf, and the leaves farthest from the loss lose the most (the
    rule of tests/test_torch_loop_jax.py).  A leaf whose true gradient is
    zero (DiffuSE's last residual conv feeds nothing; a conv bias right
    before an InstanceNorm is normalized away) holds rounding noise on
    both sides: there both RMS stay below 1e-6 of the largest leaf's."""
    assert got and set(got) <= set(want)
    rms = {name: float(np.sqrt(np.mean(want[name].double().numpy() ** 2))) for name in got}
    floor = 1e-6 * max(rms.values())
    for name, g in got.items():
        if rms[name] < floor:
            assert float(np.sqrt(np.mean(g.double().numpy() ** 2))) < floor, name
        else:
            assert rel_rms(g.numpy(), want[name].numpy()) < 1e-2, name
    flat = [np.concatenate([d[n].numpy().ravel() for n in sorted(got)]) for d in (got, want)]
    assert rel_rms(*flat) < 1e-3


def test_diffuse_step_matches_jax(diffuse_models):
    model, params, make_port = diffuse_models
    clean, noisy = signals(6)
    key = jax.random.PRNGKey(7)
    schedule = jnp.asarray(SCHEDULE, jnp.float32)
    kw = dict(model=model, criterion=jax_l1_loss)
    keep, keep_loss = jax_diffuse_step(jax_state(params, {}, KEEP_GRADS), jnp.asarray(clean),
                                       jnp.asarray(noisy), schedule, key, tx=KEEP_GRADS, **kw)
    sgd = jax_build_optimizer("sgd", 1e-3, params)
    stepped, want_loss = jax_diffuse_step(jax_state(params, {}, sgd), jnp.asarray(clean),
                                          jnp.asarray(noisy), schedule, key, tx=sgd, **kw)

    port = make_port()
    state = ModuleState(port, build_optimizer("sgd", 1e-3, port))
    grads = read_grads(state.opt, port)
    t, noise = jax_noise_draws(key, clean.shape, 50)
    loss = diffuse_step(state, torch.from_numpy(clean), torch.from_numpy(noisy), SCHEDULE, 0,
                        criterion=l1_loss, t=t, noise=noise)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    np.testing.assert_allclose(float(keep_loss), float(want_loss), rtol=1e-6)
    assert state.step == 1
    want_grads = diffuse_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                     keep.opt_state))
    assert_grads_match(grads, want_grads)
    updated = diffuse_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, stepped.params))
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), updated[name].numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=name)


def test_tsc_diffusion_step_matches_jax(tsc_models, no_flax_dropout):
    model, variables, make_port = tsc_models
    clean, noisy = signals(8)
    key = jax.random.PRNGKey(9)
    schedule = jnp.asarray(SCHEDULE, jnp.float32)
    extra = {"batch_stats": variables["batch_stats"]}
    keep, want_loss = jax_tsc_diffusion_step(jax_state(variables["params"], extra, KEEP_GRADS),
                                             jnp.asarray(clean), jnp.asarray(noisy), schedule,
                                             key, model=model, tx=KEEP_GRADS)
    # dropout is off: another dropout key gives the same loss
    _, other = jax_tsc_diffusion_step(jax_state(variables["params"], extra, KEEP_GRADS),
                                      jnp.asarray(clean), jnp.asarray(noisy), schedule, key,
                                      model=model, tx=KEEP_GRADS)
    sgd = jax_build_optimizer("sgd", 1e-3, variables["params"])
    stepped, _ = jax_tsc_diffusion_step(jax_state(variables["params"], extra, sgd),
                                        jnp.asarray(clean), jnp.asarray(noisy), schedule, key,
                                        model=model, tx=sgd)
    assert float(other) == float(want_loss)

    port = make_port()
    state = ModuleState(port, build_optimizer("sgd", 1e-3, port))
    grads = read_grads(state.opt, port)
    rng_noise, _ = jax.random.split(key)
    t, noise = jax_noise_draws(rng_noise, clean.shape, 50)
    loss = tsc_diffusion_step(state, torch.from_numpy(clean), torch.from_numpy(noisy), SCHEDULE,
                              0, t=t, noise=noise)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    host = jax.tree_util.tree_map(np.asarray, keep)
    want_grads = tsc_diffusion_state_dict_from_flax(host.opt_state, host.extra["batch_stats"])
    assert_grads_match(grads, want_grads)
    updated = jax.tree_util.tree_map(np.asarray, stepped)
    want_sd = tsc_diffusion_state_dict_from_flax(updated.params, updated.extra["batch_stats"])
    for name, p in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        rtol = 1e-5 if "running_" in name else 1e-3
        np.testing.assert_allclose(p.numpy(), want_sd[name].numpy(), rtol=rtol, atol=1e-6,
                                   err_msg=name)


def test_bf16_steps_track_fp32(diffuse_models, tsc_models):
    clean, noisy = (torch.from_numpy(a) for a in signals(10))
    for family, make_port in (("diffuse", diffuse_models[2]), ("tsc", tsc_models[2])):
        losses = {}
        for dtype in (None, torch.bfloat16):
            port = make_port()
            state = ModuleState(port, build_optimizer("sgd", 1e-3, port))
            if family == "diffuse":
                loss = diffuse_step(state, clean, noisy, SCHEDULE, 11, criterion=l1_loss,
                                    compute_dtype=dtype)
            else:
                loss = tsc_diffusion_step(state, clean, noisy, SCHEDULE, 11, compute_dtype=dtype)
            assert np.isfinite(float(loss)) and state.step == 1
            assert all(p.dtype == torch.float32 for p in port.parameters())
            assert all(b.dtype in (torch.float32, torch.int64) for b in port.buffers())
            losses[dtype] = float(loss)
        assert abs(losses[torch.bfloat16] - losses[None]) < 0.05 * (abs(losses[None]) + 1e-3)


def test_steps_are_deterministic_in_their_seed(tsc_models):
    clean, noisy = (torch.from_numpy(a) for a in signals(12))
    make_port = tsc_models[2]
    losses = []
    for seed in (3, 3, 4):
        port = make_port()
        for mod in port.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.2
        state = ModuleState(port, build_optimizer("sgd", 1e-3, port))
        losses.append(float(tsc_diffusion_step(state, clean, noisy, SCHEDULE, seed)))
    assert losses[0] == losses[1] != losses[2]


def jax_step_noises(key, shape, n_steps):
    """The normals JAX's ``lax.scan`` samplers draw at each step from
    ``key`` (``step_rng, sub = split(step_rng)``), in the order run."""
    out, step_rng = [], key
    for _ in range(n_steps):
        step_rng, sub = jax.random.split(step_rng)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("variant", ["default", "clamp_every_step", "conditioner"])
def test_sample_waveform_matches_jax(diffuse_models, variant, plain):
    model, params, make_port = diffuse_models
    _, noisy = signals(13, amplitude=0.9 if variant == "clamp_every_step" else 0.1)
    schedule = inference_schedule(SCHEDULE, FAST, fast=True)
    key = jax.random.PRNGKey(14)
    kw = {}
    if variant == "clamp_every_step":
        kw["clamp_every_step"] = True
    elif variant == "conditioner":
        kw["conditioner"] = np.abs(np.random.default_rng(15).standard_normal(
            (B, L // 100, 201))).astype(np.float32)
    want = np.asarray(jax_sample_waveform(model, {"params": params}, jnp.asarray(noisy),
                                          jax_inference_schedule(SCHEDULE, FAST, fast=True),
                                          key, **kw))
    noises = jax_step_noises(key, (B, L), 6)
    got = sample_waveform(make_port(), torch.from_numpy(noisy), schedule, noises=noises,
                          plain=plain, **kw).numpy()
    assert got.shape == (B, L) and np.abs(got).max() <= 1.0
    assert rel_rms(got, want) < 1e-4
    if variant == "clamp_every_step":
        plain_clamp = sample_waveform(make_port(), torch.from_numpy(noisy), schedule,
                                      noises=noises).numpy()
        assert rel_rms(plain_clamp, got) > 1e-3  # the per-step clamp bites here


@pytest.mark.parametrize("plain", [False, True])
def test_sample_tsc_matches_jax(tsc_models, plain):
    model, variables, make_port = tsc_models
    _, noisy = signals(16)
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax_sample_tsc(model, variables, jnp.asarray(noisy),
                                     jax_inference_schedule(SCHEDULE, FAST, fast=True), key))
    got = sample_tsc(make_port(), torch.from_numpy(noisy),
                     inference_schedule(SCHEDULE, FAST, fast=True),
                     noises=jax_step_noises(key, (B, L), 6), plain=plain).numpy()
    assert got.shape == (B, L)
    assert rel_rms(got, want) < 1e-4


def test_samplers_draw_from_their_generator(diffuse_models):
    _, noisy = signals(18)
    schedule = inference_schedule(SCHEDULE, FAST, fast=True)
    port = diffuse_models[2]()
    outs = [sample_waveform(port, torch.from_numpy(noisy), schedule,
                            torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])
