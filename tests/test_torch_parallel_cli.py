"""The training CLIs with ``--num-processes 2 --device cpu`` (the port's data
parallelism, speech_enhancement_tpu_torch/parallel): each CLI starts its two
ranks with ``spawn`` in a fresh interpreter running
tests/torch_parallel_common.py, which patches the CLI tests' widths
(TSCNet(8), Discriminator(4), DiffusionTSCNet(8)) into every rank.  One
epoch on tests/test_torch_cli.py's tiny corpus; the steps themselves are
held to one process in tests/test_torch_parallel.py.
"""

import numpy as np
import pytest
from torch_parallel_common import run_cli


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """tests/test_torch_cli.py's tiny VoiceBank-style corpus (batch 2, 40-frame
    crops; 4 training and 3 test utterances)."""
    from speech_enhancement_tpu_torch.data import save_wav

    root = tmp_path_factory.mktemp("vb_port_parallel")
    rng = np.random.default_rng(0)
    t = np.arange(20000) / 16000
    dirs = {}
    for split, n in [("train", 4), ("test", 3)]:
        cdir, ndir = root / f"clean_{split}", root / f"noisy_{split}"
        cdir.mkdir()
        ndir.mkdir()
        for i in range(n):
            clean = (0.3 * np.sin(2 * np.pi * (180 + 50 * i) * t)).astype(np.float32) * (
                0.5 + 0.5 * np.sin(2 * np.pi * 2.7 * t))
            noisy = clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32)
            save_wav(cdir / f"p{i:03d}.wav", clean)
            save_wav(ndir / f"p{i:03d}.wav", noisy)
        dirs[split] = (str(cdir), str(ndir))
    cfg = root / "tiny.yaml"
    cfg.write_text(f"""
DATA:
  TRAIN_CLEAN_DIR: {dirs['train'][0]}
  TRAIN_NOISY_DIR: {dirs['train'][1]}
  TEST_CLEAN_DIR: {dirs['test'][0]}
  TEST_NOISY_DIR: {dirs['test'][1]}
  BATCH_SIZE: 2
CROP_FRAMES: 40
""")
    return root, str(cfg)


@pytest.mark.parametrize("module, arch, extra", [
    ("main_gan", "scp", ["--step-mode", "pipelined", "--fused-attention"]),
    ("main_diffuse", "tsc-diffuse", []),
])
def test_training_cli_on_two_processes(tiny_corpus, tmp_path, module, arch, extra):
    """One epoch with ``--num-processes 2 --device cpu``: the CLI starts both
    ranks; both end with bitwise-equal replicas (the digests each logs),
    and rank 0 alone writes the checkpoint."""
    _, cfg = tiny_corpus
    out = tmp_path / "out"
    proc = run_cli(module, ["-a", arch, "--cfg", cfg, "--output", str(out), "--epochs", "1",
                            "--seed", "3", "-j", "1", "-p", "1", "--num-processes", "2",
                            "--device", "cpu", *extra], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = out / arch / "default"
    assert sorted(p.name for p in run.glob("checkpoint_*")) == ["checkpoint_0000"]
    assert (run / "checkpoint_0000" / "variables.pt").exists()
    logs = [(run / f"log_rank{r}.txt").read_text() for r in range(2)]
    digests = [[line.split("replicas: ", 1)[1] for line in log.splitlines()
                if "replicas: " in line] for log in logs]
    assert digests[0] and digests[0] == digests[1], digests
    assert "ranks: 2 (gloo)" in logs[0]
    assert "saved checkpoint_0000" in logs[0]
    assert "saved checkpoint_0000" not in logs[1]
