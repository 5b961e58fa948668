"""Device selection in the port: the entry points run on the card unless
the caller passes ``device="cpu"``, and raise on a host without a card.

Whether the host has a card is monkeypatched, so the tests run alike on
every host; no tensor is moved to a card.
"""

import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch import enhance
from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
from speech_enhancement_tpu_torch.utils.device import resolve_device

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


def test_default_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cuda:0") == torch.device("cuda:0")


def test_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_cpu_when_asked(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device(device) == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """TSCNet(), Discriminator(), Enhancer(model) and predict_one(...)
    without a device ask for the card, so they raise on a host without
    one; with device='cpu' they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSCNet(4, 201)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Discriminator(4)
    model = TSCNet(4, 201, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert next(Discriminator(4, device="cpu").parameters()).device.type == "cpu"
    noisy = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enhance.Enhancer(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enhance.predict_one(model, noisy)
    out = enhance.predict_one(model, noisy, device="cpu")
    assert out.shape == (1000,) and np.isfinite(out).all()
