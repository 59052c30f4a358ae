"""The float64 gradient judge (wsi_hgnn_tpu_torch/train/gradcheck.py) on
the CPU: one ABMIL Adam step, with a second 'device' step that is also
run on the CPU. A step that only sums in another order passes, including
the softmax bias whose exact gradient is 0; a sign flip, f32 products
rounded to TF32 or bf16, and a nonzero gradient of a dead layer fail.
"""
import copy

import pytest
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from wsi_hgnn_tpu_torch import convert
from wsi_hgnn_tpu_torch.models.mil import ABMIL
from wsi_hgnn_tpu_torch.train import gradcheck
import port_threads  # noqa: F401  (torch threads per test worker)

CPU = torch.device("cpu")
N, D = 300, 64


class WithDeadLayer(nn.Module):
    """ABMIL plus a linear layer whose output is multiplied by 0: its
    gradient is exactly 0 in every precision."""

    def __init__(self):
        super().__init__()
        self.abmil = ABMIL(2, D)
        self.dead = nn.Linear(D, 2)

    def forward(self, x, mask):
        return self.abmil(x, mask) + 0.0 * self.dead(x[:1])


class RoundProducts(TorchDispatchMode):
    """The operands of every matrix product rounded to nearest with
    `bits` mantissa bits (10: TF32, 7: bf16), as reduced-precision
    products read them."""

    PRODUCTS = ("mm", "addmm", "bmm", "mv", "addmv", "matmul", "linear")

    def __init__(self, bits):
        super().__init__()
        self.drop = 23 - bits

    def _round(self, t):
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32):
            return t
        i = t.view(torch.int32)
        half = 1 << (self.drop - 1)
        return ((i + half) & ~((1 << self.drop) - 1)).view(torch.float32)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.PRODUCTS:
            args = tuple(self._round(a) for a in args)
        return func(*args, **(kwargs or {}))


def _bag(seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, D).astype(np.float32))
    return x, torch.arange(N) < N - 20


def _step(m, x, mask, dtype=torch.float32):
    opt = torch.optim.Adam(m.parameters(), lr=2e-4, betas=(0.5, 0.9),
                           weight_decay=5e-3)
    opt.zero_grad()
    F.cross_entropy(m(x.to(dtype), mask), torch.tensor([1])).backward()
    opt.step()


def _judge(device_step, plant=None, after=None):
    """judge() on the CPU step against `device_step(model, dtype)` (the
    'device'; `plant` alters its f32 and float64 models, `after` its
    gradients); returns (text, failed names)."""
    model = WithDeadLayer()
    convert.init_flax_like_(model, seed=1)
    base64 = copy.deepcopy(model).double()
    x, mask = _bag()
    m32, md = copy.deepcopy(model), copy.deepcopy(model)
    _step(m32, x, mask)
    if plant is not None:
        plant(md)
    device_step(md, torch.float32)
    if after is not None:
        after(md)
    m64 = copy.deepcopy(base64)
    with gradcheck.float64_default():
        _step(m64, x, mask, torch.float64)
    g64 = gradcheck._grads(m64.named_parameters())

    def dev64():
        m = copy.deepcopy(base64)
        if plant is not None:
            plant(m)
        with gradcheck.float64_default():
            device_step(m, torch.float64)
        return m.named_parameters()

    def run64(m):
        _step(m, x, mask, torch.float64)

    return gradcheck.judge(
        m32.named_parameters(), md.named_parameters(),
        m64.named_parameters(),
        lambda: gradcheck.rounding_spread(run64, base64, g64), dev64)


def _reordered(m, dtype):
    """The same step on the bag's instances in reverse order: the same
    function, summed in another order."""
    x, mask = _bag()
    _step(m, x.flip(0), mask.flip(0), dtype)


def test_judge_passes_a_step_summed_in_another_order():
    text, failed = _judge(_reordered)
    assert not failed, (failed, text)
    # the softmax bias (exact gradient 0) is beyond GRAD_RTOL and judged
    # by float64; the dead layer is exactly 0 on both sides
    assert "judged by float64" in text, text


def test_judge_fails_a_sign_flip():
    def plant(m):
        m.abmil.attention_0.register_forward_hook(lambda mod, i, o: -o)

    text, failed = _judge(_reordered, plant=plant)
    assert "abmil.attention_0.weight" in failed, (failed, text)


@pytest.mark.parametrize("bits", [10, 7], ids=["tf32", "bf16"])
def test_judge_fails_reduced_precision_products(bits):
    def rounded(m, dtype):
        if dtype == torch.float64:
            return _reordered(m, dtype)
        with RoundProducts(bits):
            _reordered(m, dtype)

    text, failed = _judge(rounded)
    assert failed, text


def test_judge_fails_a_dead_layer_with_a_gradient():
    def touch(m):
        m.dead.bias.grad[0] = 1e-30

    text, failed = _judge(_reordered, after=touch)
    assert failed == ["dead.bias"], (failed, text)
