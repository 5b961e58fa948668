"""The port's data parallelism (speech_enhancement_tpu_torch/parallel) on the
CPU: two ranks of a gloo group, each a process of
tests/torch_parallel_common.py (its own timeout and a free port, so that a
hang fails the test), against one process at the global batch and against
the JAX steps sharded over the conftest's 8-device mesh.  Sizes of
tests/distributed_trainstep_common.py: TSCNet(8, 201), Discriminator(4),
B 8 (4 rows a rank), L 2000, every dropout rate 0 (flax's patched off).

Bounds, 2 ranks against one port process: BatchNorm1d's batch and running
statistics and input gradient rtol 1e-5 (as tests/test_parallel.py holds
JAX's); the GAN and diffusion steps' losses and self-correcting weights
rtol 1e-5, their gradients relative RMS < 1e-5 over all leaves, the
updated parameters and BatchNorm running statistics rtol 1e-5 (atol
1e-7), and the two ranks' states bitwise equal.  The steps are held to one
process in float64 (both sides; the all-reduce buffer is fp32): in fp32
the order of the reductions alone moves the generator's gradients by a
relative RMS of 2.6e-4 and the diffusion TSCNet's by 6.1e-5 (measured on
the CPU), since the network at this random init amplifies rounding
(tests/test_torch_gan_step.py).  Against the JAX sharded steps, in fp32,
tests/test_torch_gan_step.py's fp32 bounds: the generator's losses rtol
1e-5, gradients relative RMS < 1e-3 over all leaves and < 1e-2 per leaf;
the discriminator's loss rtol 1e-4, the bound of the estimate it reads
(2.2e-5 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_common import (
    branch_labels,
    collect,
    diffusion_draws,
    diffusion_models,
    make_batch,
    run_batchnorm,
    run_diffusion_steps,
    run_gan_steps,
    start_ranks,
)
from torch_train_common import KEEP_GRADS, jax_setup, no_flax_dropout, rel_rms, rms  # noqa: F401

from speech_enhancement_tpu.parallel import data_parallel_mesh, replicate_state, shard_batch
from speech_enhancement_tpu.train import gan_discriminator_step as jax_gan_discriminator_step
from speech_enhancement_tpu.train import gan_generator_step as jax_gan_generator_step
from speech_enhancement_tpu.train import l2_loss as jax_l2_loss
from speech_enhancement_tpu_torch import parallel
from speech_enhancement_tpu_torch.enhance import Enhancer
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.utils.convert import (
    discriminator_state_dict_from_flax,
    state_dict_from_flax,
)

torch.set_num_threads(1)


def assert_states_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def assert_states_close(got: dict, want: dict):
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=1e-5, atol=1e-7, msg=key)


def flat_rel_rms(got: dict, want: dict, keys) -> float:
    return rel_rms(*(torch.cat([d[k].reshape(-1) for k in keys]) for d in (got, want)))


def test_shard_rows_split_contiguously():
    rows = np.arange(5)
    assert [parallel.shard_rows(rows, r, 2).tolist() for r in range(2)] == [[0, 1, 2], [3, 4]]
    assert [len(parallel.shard_rows(rows, r, 8)) for r in range(8)] == [1] * 5 + [0] * 3
    assert parallel.shard_rows(rows).tolist() == rows.tolist()  # one process


def test_batchnorm_statistics_are_global(tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((1.5 + rng.standard_normal((8, 16, 30))).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((8, 16, 30)).astype(np.float32))
    procs = start_ranks("batchnorm", tmp_path, {"x": x, "g": g})
    want = run_batchnorm(x, g)
    ranks = collect(procs, "batchnorm", tmp_path)
    for key in ("mean", "var", "running_mean", "running_var"):
        for got in ranks:
            torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=0, msg=key)
    for key in ("y", "grad"):
        got = torch.cat([r[key] for r in ranks])
        torch.testing.assert_close(got, want[key], rtol=1e-5, atol=1e-6, msg=key)


@pytest.fixture(scope="module")
def jax_gan():
    """The JAX models and GAN state (gradient-keeping transformations) and
    the port's variables converted from it."""
    gen, disc, _, _, jstate = jax_setup(False, KEEP_GRADS, KEEP_GRADS)
    host = jax.tree_util.tree_map(np.asarray, jstate)
    variables = {"gen": state_dict_from_flax(host.gen.params, host.gen.extra["batch_stats"]),
                 "disc": discriminator_state_dict_from_flax(host.disc.params,
                                                            host.disc.extra["spectral"])}
    return gen, disc, jstate, variables


def jax_sharded_steps(gen, disc, jstate, batch):
    """The JAX generator and discriminator steps with the batch sharded over
    the 8-device mesh: (generator metrics, discriminator loss, gradients by
    the port's names)."""
    clean, noisy, q_est, q_clean, q_noisy = batch
    mesh = data_parallel_mesh(8)
    state = replicate_state(mesh, jstate)
    c_sh, n_sh = shard_batch(mesh, clean, noisy)
    state, aux = jax_gan_generator_step(state, c_sh, n_sh, jax.random.PRNGKey(1),
                                        gen_model=gen, disc_model=disc, arch="scp",
                                        criterion=jax_l2_loss, gan_active=True,
                                        gen_tx=KEEP_GRADS)
    state, disc_loss = jax_gan_discriminator_step(
        state, aux, *(jnp.asarray(q) for q in (q_est, q_clean, q_noisy)),
        jax.random.PRNGKey(2), disc_model=disc, arch="scp", criterion=jax_l2_loss,
        disc_tx=KEEP_GRADS)
    host = jax.tree_util.tree_map(np.asarray, state)
    grads = {f"gen.{k}": v for k, v in
             state_dict_from_flax(host.gen.opt_state, host.gen.extra["batch_stats"]).items()}
    grads.update((f"disc.{k}", v) for k, v in discriminator_state_dict_from_flax(
        host.disc.opt_state, host.disc.extra["spectral"]).items())
    return {k: float(v) for k, v in aux.metrics.items()}, float(disc_loss), grads


@pytest.mark.parametrize("labels", ["default", "gram_branch"])
def test_gan_steps_match_one_process_and_jax_sharded(no_flax_dropout, jax_gan,  # noqa: F811
                                                     tmp_path, labels):
    """One scp generator step and one discriminator step over 2 x 4 rows.
    ``gram_branch``: labels under which rank 0's own gradients would take
    another self-correcting branch than the global ones (asserted); the
    ranks must take the global one."""
    gen, disc, jstate, variables = jax_gan
    batch = make_batch()
    if labels == "gram_branch":
        batch = (*batch[:2], *branch_labels())
    procs = start_ranks("gan", tmp_path, {"variables": variables, "batch": batch})
    one = run_gan_steps(variables, *batch, dtype=torch.float64)
    jax_metrics, jax_disc_loss, jax_grads = jax_sharded_steps(gen, disc, jstate, batch)
    ranks = collect(procs, "gan", tmp_path)

    for dtype in (torch.float32, torch.float64):  # bitwise-equal replicas
        first = ranks[0][dtype]
        for r in ranks[1:]:
            assert_states_equal(r[dtype]["gen"], first["gen"])
            assert_states_equal(r[dtype]["disc"], first["disc"])
            assert r[dtype]["metrics"] == first["metrics"]
            assert r[dtype]["disc_loss"] == first["disc_loss"]
            assert torch.equal(r[dtype]["weights"], first["weights"])

    # float64 against one process
    got = ranks[0][torch.float64]
    for name, value in one["metrics"].items():
        np.testing.assert_allclose(got["metrics"][name], value, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(got["disc_loss"], one["disc_loss"], rtol=1e-5)
    torch.testing.assert_close(got["weights"], one["weights"], rtol=1e-5, atol=0)
    for tag in ("gen.", "disc."):
        keys = [k for k in one["grads"] if k.startswith(tag)]
        assert flat_rel_rms(got["grads"], one["grads"], keys) < 1e-5, tag
    assert_states_close(got["gen"], one["gen"])  # updated parameters, running statistics
    assert_states_close(got["disc"], one["disc"])

    # fp32 against the JAX steps sharded over 8 devices
    got = ranks[0][torch.float32]
    for name, value in jax_metrics.items():
        np.testing.assert_allclose(got["metrics"][name], value, rtol=1e-5, err_msg=name)
    # the discriminator's inputs carry the generator's fp32 distance from JAX
    # (est_audio within 1e-4, tests/test_torch_gan_step.py)
    np.testing.assert_allclose(got["disc_loss"], jax_disc_loss, rtol=1e-4)
    for tag in ("gen.", "disc."):
        keys = [k for k in got["grads"] if k.startswith(tag)]
        assert flat_rel_rms(got["grads"], jax_grads, keys) < 1e-3, tag
        largest = max(rms(jax_grads[k]) for k in keys)
        for k in keys:
            if rms(jax_grads[k]) < 1e-6 * largest:  # an exact zero, up to rounding
                assert rms(got["grads"][k]) < 1e-6 * largest, k
            else:
                assert rel_rms(got["grads"][k], jax_grads[k]) < 1e-2, k

    if labels == "gram_branch":
        for dtype in (torch.float32, torch.float64):
            w, local = ranks[0][dtype]["weights"], ranks[0][dtype]["local_weights"]
            assert float(w[1]) < 1.0 and float(local[1]) == 1.0, (dtype, w, local)


def test_diffusion_steps_match_one_process(tmp_path):
    """``diffuse_step`` and ``tsc_diffusion_step`` over 2 x 4 rows in float64,
    with the global batch's timesteps and noise split with its rows."""
    clean, noisy, *_ = make_batch()
    variables = {k: m.state_dict() for k, m in diffusion_models().items()}
    t, noise = diffusion_draws()
    batch = (clean, noisy, t, noise)
    procs = start_ranks("diffusion", tmp_path, {"variables": variables, "batch": batch})
    one = run_diffusion_steps(variables, *batch)
    ranks = collect(procs, "diffusion", tmp_path)
    for name in ("diffuse", "tsc"):
        assert_states_equal(ranks[1][name]["state"], ranks[0][name]["state"])
        got, want = ranks[0][name], one[name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=name)
        assert flat_rel_rms(got["grads"], want["grads"], want["grads"]) < 1e-5, name
        assert_states_close(got["state"], want["state"])
    np.testing.assert_allclose(ranks[0]["diffuse_norm"], one["diffuse_norm"], rtol=1e-5)
    assert ranks[0]["diffuse_norm"] == ranks[1]["diffuse_norm"]


def test_a_stop_on_one_rank_stops_both(tmp_path):
    ranks = collect(start_ranks("stop", tmp_path), "stop", tmp_path)
    assert ranks == [{"stopped": True, "steps": 1}] * 2


def test_enhancer_on_two_devices_matches_one():
    """5 ragged utterances: the batch of 5 is padded to 6 rows and split 3 +
    3 over two replicas (tests/test_parallel.py's bound)."""
    rng = np.random.default_rng(1)
    utts = [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in (3000, 4100, 2500, 3900, 3300)]
    gen = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(3))
    want = Enhancer(gen, quantum=4000, device="cpu").enhance(utts, batch_size=5)
    got = Enhancer(gen, quantum=4000, devices=["cpu", "cpu"]).enhance(utts, batch_size=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5)
    with pytest.raises(ValueError):
        Enhancer(gen, device="cpu", devices=["cpu"])

