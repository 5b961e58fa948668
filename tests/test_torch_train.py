"""The port's training pieces other than the generator step's parity
(tests/test_torch_gan_step*.py), on the CPU:

* BatchNorm's train-mode running statistics against flax (rtol 1e-5):
  torch's own update uses the unbiased batch variance, flax the biased;
* one ConformerBlock's train-mode gradients against flax (relative RMS
  < 1e-5: the same fp32 math in another order);
* the compress gradient at exact-zero bins: finite, and equal (rtol 1e-5)
  to the complex conjugate of ``jax.grad`` (torch and JAX define the
  gradient with respect to a complex input as conjugates);
* the discriminator step for scp and cmgan against the JAX step, with
  stubbed labels: the self-correcting weights and the loss rtol 1e-5, the
  combined gradient relative RMS < 1e-4, the SGD-updated parameters and
  the refreshed spectral-norm pairs rtol 1e-5; ``_sc_weights_from_gram``
  on Gram matrices that reach every branch;
* the bf16 generator step against the port's fp32 step (loss rtol 0.1, the
  bound of tests/test_bf16_training.py), fp32 masters and statistics;
* rematerialization: statistics and gradients as without it (1e-6), the
  statistics updated once;
* ``make_fused_gan_train_step`` with the native PESQ engine's labels: two
  finite steps, the same again from the same state and seed;
* ``gan_eval_step``: per-example losses average to the batch losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_common import B, KEEP_GRADS, L, read_grads, rel_rms

from speech_enhancement_tpu.models.conformer import ConformerBlock as FlaxConformerBlock
from speech_enhancement_tpu.ops.stft import power_compress as jax_power_compress
from speech_enhancement_tpu.ops.stft import power_uncompress as jax_power_uncompress
from speech_enhancement_tpu.train import gan as jax_gan
from speech_enhancement_tpu.train import l2_loss as jax_l2_loss
from speech_enhancement_tpu_torch.models import ConformerBlock, Discriminator, TSCNet
from speech_enhancement_tpu_torch.ops.stft import power_compress, power_uncompress
from speech_enhancement_tpu_torch.train import (
    GenAux,
    create_gan_state,
    gan_discriminator_step,
    gan_eval_step,
    gan_generator_step,
    l2_loss,
    make_fused_gan_train_step,
    self_correcting_weights,
)
from speech_enhancement_tpu_torch.train.gan import _sc_weights_from_gram
from speech_enhancement_tpu_torch.utils.convert import (
    conformer_state_dict,
    discriminator_state_dict_from_flax,
)

# one intra-op thread: the pytest-xdist workers share the cores, and with
# torch's default of a thread per core in each, these tests took 3.5x as long
torch.set_num_threads(1)


def _flax_block(seed, fused=False):
    x = np.random.default_rng(seed).standard_normal((3, 29, 16)).astype(np.float32)
    block = FlaxConformerBlock(dim=16, dim_head=4, heads=4, fused_attention=fused)
    variables = jax.tree_util.tree_map(
        np.asarray, block.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x)))
    port = ConformerBlock(16, dim_head=4, heads=4, fused_attention=fused).train()
    port.load_state_dict(conformer_state_dict(variables["params"], variables["batch_stats"]),
                         strict=True)
    return x, block, variables, port


def test_batchnorm_running_variance_is_biased_as_flax():
    x, block, variables, port = _flax_block(0)
    _, updates = block.apply(variables, jnp.asarray(x), deterministic=False,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
    want = jax.tree_util.tree_map(np.asarray, updates["batch_stats"])["conv"]["BatchNorm_0"]
    with torch.no_grad():
        port(torch.from_numpy(x))
    bn = port.conv.net[5]
    np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), want["var"], rtol=1e-5, atol=1e-7)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_conformer_block_train_gradients_match_flax(fused):
    x, block, variables, port = _flax_block(2, fused)
    gy = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def loss(params):
        y, _ = block.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x), deterministic=False, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(4)})
        return jnp.sum(y * gy)

    grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(variables["params"]))
    want = conformer_state_dict(grads, variables["batch_stats"])
    (port(torch.from_numpy(x)) * torch.from_numpy(gy)).sum().backward()
    for name, p in port.named_parameters():
        if name == "conv.net.4.conv.bias":  # feeds the BatchNorm: an exact zero
            assert float(p.grad.abs().max()) < 1e-5, name
        else:
            assert rel_rms(p.grad, want[name]) < 1e-5, name


@pytest.mark.parametrize("jax_fn,port_fn", [(jax_power_compress, power_compress),
                                            (jax_power_uncompress, power_uncompress)],
                         ids=["compress", "uncompress"])
def test_compress_gradient_at_zero_bins_is_conj_of_jax(jax_fn, port_fn):
    spec = np.array([[0.0, 1.0 + 1.0j, 0.5 - 0.2j, 0.0]], np.complex64)
    wr = np.array([[0.3, -1.2, 0.7, 2.0]], np.float32)
    wi = np.array([[1.1, 0.4, -0.5, -1.0]], np.float32)

    def jax_loss(s):
        out = jax_fn(s)
        return jnp.sum(jnp.real(out) * wr + jnp.imag(out) * wi)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(spec)))
    st = torch.from_numpy(spec).requires_grad_()
    out = port_fn(st)
    (out.real * torch.from_numpy(wr) + out.imag * torch.from_numpy(wi)).sum().backward()
    got = st.grad.numpy()
    assert np.isfinite(got).all()
    assert got[0, 0] == 0 and got[0, 3] == 0
    np.testing.assert_allclose(got, np.conj(want), rtol=1e-5, atol=1e-7)


def _gram(seed, ce_sign, s_sign):
    """A Gram matrix of three random 50-vectors with sign(C.E) and
    sign((w_c C + w_e E).N) as asked."""
    r = np.random.default_rng(seed)
    gc, ge, gn = (r.standard_normal(50) for _ in range(3))
    if np.sign(gc @ ge) != ce_sign:
        ge = -ge
    w_e = 1.0 if gc @ ge > 0 else -(gc @ ge) / (ge @ ge + 1e-14)
    if np.sign((gc + w_e * ge) @ gn) != s_sign:
        gn = -gn
    g = np.stack([gc, ge, gn]).astype(np.float32)
    return g @ g.T


@pytest.mark.parametrize("ce_sign,s_sign", [(1, 1), (1, -1), (-1, 1), (-1, -1)])
def test_sc_weights_from_gram_match_jax_on_every_branch(ce_sign, s_sign):
    for seed in range(3):
        gram = _gram(seed, ce_sign, s_sign)
        want = np.asarray(jax_gan._sc_weights_from_gram(jnp.asarray(gram)))
        got = _sc_weights_from_gram(torch.from_numpy(gram)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _aux_mags(seed, t=41, f=201):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.standard_normal((B, t, f))).astype(np.float32) * s
            for s in (1.0, 0.8, 1.3)]  # clean, est, noisy


LABELS = [np.array([0.62, 0.35], np.float32), np.full((B,), (4.64 - 1) / 3.5, np.float32),
          np.array([0.21, 0.40], np.float32)]  # est, clean, noisy


def _disc_states(disc_tx=None):
    """A JAX GAN state whose discriminator is initialized as in
    tests/test_train_gan.py (its generator is left out: the discriminator
    step does not read it), and the port's state on the same weights."""
    import optax

    from speech_enhancement_tpu.models import Discriminator as FlaxDiscriminator
    from speech_enhancement_tpu.train import ModuleState, build_optimizer
    from speech_enhancement_tpu.train.state import GanTrainState

    disc = FlaxDiscriminator(ndf=4, dropout=0.0)
    mag = jnp.zeros((1, 41, 201))
    variables = disc.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                          mag, mag)
    tx = disc_tx or build_optimizer("sgd", 2e-3, variables["params"])
    jstate = GanTrainState(
        gen=ModuleState(params={}, extra={}, opt_state=optax.EmptyState()),
        disc=ModuleState(params=variables["params"], extra={"spectral": variables["spectral"]},
                         opt_state=tx.init(variables["params"])))
    host = jax.tree_util.tree_map(np.asarray, variables)
    port_disc = Discriminator(4, dropout=0.0, device="cpu")
    port_disc.load_state_dict(discriminator_state_dict_from_flax(host["params"],
                                                                 host["spectral"]), strict=True)
    state = create_gan_state(torch.nn.Linear(1, 1), port_disc, "sgd", 1e-3)
    return disc, tx, jstate, state


@pytest.mark.parametrize("arch", ["scp", "cmgan"])
def test_discriminator_step_matches_jax(arch):
    clean_mag, est_mag, noisy_mag = _aux_mags(5)
    q_est, q_clean, q_noisy = LABELS
    zeros = jnp.zeros((B, L))
    jaux = jax_gan.GenAux(zeros, zeros, zeros, jnp.asarray(est_mag), jnp.asarray(clean_mag),
                          jnp.asarray(noisy_mag), {})
    port_aux = GenAux(*(torch.zeros(B, L) for _ in range(3)), torch.from_numpy(est_mag),
                      torch.from_numpy(clean_mag), torch.from_numpy(noisy_mag), {})
    labels = [torch.from_numpy(a) for a in LABELS]
    for disc_tx in (KEEP_GRADS, None):  # the gradient itself, then an SGD update
        disc, tx, jstate, state = _disc_states(disc_tx)
        jstate1, jloss = jax_gan.gan_discriminator_step(
            jstate, jaux, jnp.asarray(q_est), jnp.asarray(q_clean), jnp.asarray(q_noisy),
            jax.random.PRNGKey(2), disc_model=disc, arch=arch, criterion=jax_l2_loss,
            disc_tx=tx)
        grads = read_grads(state.disc_opt, state.disc)
        loss = gan_discriminator_step(state, port_aux, *labels, 0, criterion=l2_loss,
                                      arch=arch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        host = jax.tree_util.tree_map(np.asarray, jstate1.disc)
        got = state.disc.state_dict()
        if disc_tx is KEEP_GRADS:
            want = discriminator_state_dict_from_flax(host.opt_state, host.extra["spectral"])
            flat = [torch.cat([d[k].reshape(-1) for k in grads]) for d in (grads, want)]
            assert rel_rms(*flat) < 1e-4
        else:
            want = discriminator_state_dict_from_flax(host.params, host.extra["spectral"])
            for key, value in want.items():  # updated params and refreshed (u, v)
                torch.testing.assert_close(got[key], value, rtol=1e-5, atol=1e-6, msg=key)


def test_discriminator_step_sc_weights_match_jax():
    """The weights the scp step combines with, from the three per-term
    gradients of each side."""
    clean_mag, est_mag, noisy_mag = _aux_mags(6)
    q_est, q_clean, q_noisy = LABELS
    disc, _, jstate, state = _disc_states()
    spectral = jstate.disc.extra["spectral"]

    @jax.jit
    def grad(params, other, label):
        def f(p):
            out = disc.apply({"params": p, "spectral": spectral}, jnp.asarray(clean_mag),
                             other, deterministic=True).reshape(-1)
            return jax_l2_loss(out, label)
        return jax.grad(f)(params)

    def term(other, label):
        return grad(jstate.disc.params, jnp.asarray(other), jnp.asarray(label))

    want = jax_gan.self_correcting_weights(term(clean_mag, q_clean), term(est_mag, q_est),
                                           term(noisy_mag, q_noisy))
    params = list(state.disc.parameters())
    grads = []
    for other, label in ((clean_mag, q_clean), (est_mag, q_est), (noisy_mag, q_noisy)):
        out = state.disc(torch.from_numpy(clean_mag), torch.from_numpy(other)).reshape(-1)
        grads.append(torch.autograd.grad(l2_loss(out, torch.from_numpy(label)), params))
    got = self_correcting_weights(*grads)
    np.testing.assert_allclose([float(w) for w in got], [float(w) for w in want], rtol=1e-5)


def _port_batch(seed=0):
    rng = np.random.default_rng(seed)
    clean = torch.from_numpy((0.1 * rng.standard_normal((B, L))).astype(np.float32))
    return clean, clean + 0.02 * torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32))


def _fresh_state(remat=True, seed=7):
    gen = TSCNet(8, 201, remat=remat, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    disc = Discriminator(4, device="cpu", generator=torch.Generator().manual_seed(seed + 1))
    return create_gan_state(gen, disc, "sgd", 1e-3)


def test_bf16_generator_step_close_to_fp32():
    clean, noisy = _port_batch(1)
    s32, s16 = _fresh_state(), _fresh_state()
    before = {k: v.clone() for k, v in s16.gen.state_dict().items()}
    a32 = gan_generator_step(s32, clean, noisy, 3, criterion=l2_loss)
    a16 = gan_generator_step(s16, clean, noisy, 3, criterion=l2_loss,
                             compute_dtype=torch.bfloat16)
    l32, l16 = float(a32.metrics["loss"]), float(a16.metrics["loss"])
    assert np.isfinite(l16)
    np.testing.assert_allclose(l16, l32, rtol=0.1)
    after = s16.gen.state_dict()
    assert all(v.dtype in (torch.float32, torch.int64) for v in after.values())
    assert max(float((after[k] - before[k]).abs().max()) for k in after
               if not k.endswith("num_batches_tracked")) > 0
    stats = [v for k, v in after.items() if k.endswith(("running_mean", "running_var"))]
    assert stats and all(v.dtype == torch.float32 for v in stats)
    assert any(not torch.equal(after[k], before[k]) for k in after if k.endswith("running_var"))


def test_remat_keeps_statistics_and_gradients():
    clean, noisy = _port_batch(2)
    out = {}
    for remat in (False, True):
        state = _fresh_state(remat)
        for m in state.gen.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        grads = read_grads(state.gen_opt, state.gen)
        gan_generator_step(state, clean, noisy, 5, criterion=l2_loss)
        out[remat] = grads, state.gen.state_dict()
    (g0, sd0), (g1, sd1) = out[False], out[True]
    for key in g0:
        torch.testing.assert_close(g1[key], g0[key], rtol=1e-6, atol=1e-9, msg=key)
    for key in sd0:
        if key.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(sd1[key], sd0[key], rtol=1e-6, atol=1e-9, msg=key)
        elif key.endswith("num_batches_tracked"):
            assert int(sd1[key]) == int(sd0[key]) == 1, key


def test_remat_repeats_dropout_masks():
    """With dropout on, the recompute draws the forward's masks again: the
    step with remat equals the step without."""
    clean, noisy = _port_batch(3)
    grads = {}
    for remat in (False, True):
        state = _fresh_state(remat)
        grads[remat] = read_grads(state.gen_opt, state.gen)
        gan_generator_step(state, clean, noisy, 9, criterion=l2_loss)
    for key in grads[False]:
        torch.testing.assert_close(grads[True][key], grads[False][key], rtol=1e-6,
                                   atol=1e-9, msg=key)


def _tone_batch():
    t = np.arange(L) / 16000.0
    tone = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    clean = torch.from_numpy(np.stack([tone, tone]).astype(np.float32))
    noise = np.random.default_rng(4).standard_normal((B, L)).astype(np.float32)
    return clean, clean + 0.02 * torch.from_numpy(noise)


def test_fused_train_step_with_host_pesq_labels_is_deterministic():
    clean, noisy = _tone_batch()
    step = make_fused_gan_train_step(criterion=l2_loss, arch="scp")
    runs = []
    for _ in range(2):
        state = _fresh_state()
        metrics = [step(state, clean, noisy, seed) for seed in (11, 12)]
        runs.append((metrics, state.disc.state_dict(), state.gen.state_dict()))
        assert state.gen_step == state.disc_step == 2
    for metrics in runs[0][0]:
        assert all(np.isfinite(float(v)) for v in metrics.values())
    for a, b in zip(runs[0][0], runs[1][0]):
        assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    for sd_a, sd_b in zip(runs[0][1:], runs[1][1:]):
        for key in sd_a:
            assert torch.equal(sd_a[key], sd_b[key]), key


def test_eval_step_per_example_averages_to_batch_losses():
    clean, noisy = _port_batch(5)
    state = _fresh_state()
    scalar, _ = gan_eval_step(state, clean, noisy, criterion=l2_loss)
    vector, aux = gan_eval_step(state, clean, noisy, criterion=l2_loss, per_example=True)
    assert vector["loss"].shape == (B,) and aux.metrics["d_fake"].shape == (B,)
    for key, value in scalar.items():
        np.testing.assert_allclose(float(vector[key].mean()), float(value), rtol=1e-5,
                                   err_msg=key)
