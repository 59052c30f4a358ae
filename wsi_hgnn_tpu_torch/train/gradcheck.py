"""The card-versus-CPU gradient check of one training step, judged by
float64.

Each parameter's f32 gradient after the same step (same weights, batch,
augmentation and dropout masks) on the card and on the CPU:

1. within GRAD_RTOL relative L2 of the CPU's, it passes;
2. otherwise it passes only where float64 explains the miss:
   - the card computes the same function: the card's float64 gradient is
     within float64 rounding of the CPU's float64 gradient;
   - the card's f32 gradient is within f32 rounding of float64's:
     ||g_card - g_64|| <= GRAD_F32 * s + GRAD_NOISE * G_64.

s is what f32 rounding does to this gradient, measured in float64 and
nowhere else: the largest distance from g_64 over DRAWS float64 steps in
which the result of every rounding operation is multiplied by (1 + e), e
uniform in [-2^-24, 2^-24] elementwise (f32's unit roundoff), and its
operands by (1 + sqrt(n) e), n the number of terms each result element
sums (`RandomRounding`, Monte Carlo arithmetic). An f32 sum of n terms
rounds each of its n partial sums, a random walk whose error grows like
sqrt(n) roundings of the running sum; perturbing the operands gives a
fused operation (a matrix product, a softmax backward, a segment sum)
that error where its terms cancel inside it. Operations whose result is
exact in any precision (maxima, sorts, selections, copies, comparisons,
constants) are left alone: a maximum must stay equal to one of its
inputs, or its backward finds no element to route the gradient to. A
gradient that cancels to about 0 from large terms gets an s of the
terms' size, a well-conditioned one an s of its own. The CPU's own f32
summation order, luckier or not than the card's atomics, no longer sets
the bound. The float64 comparison of step 2 uses the same s scaled to
float64's unit roundoff (2^-53 / 2^-24).

G_64 is the largest float64 gradient norm of the model; GRAD_NOISE of it
covers gradients whose exact value is about 0 and whose terms the draws
happen to perturb little. A gradient that is exactly 0 in float64 and in
every randomly rounded step (a dead layer, which no arithmetic makes
nonzero) must be exactly 0 on the card. A gradient that merely cancels
to exactly 0 in one precision on one device (a bias under a softmax) is
judged like any other.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

GRAD_RTOL, GRAD_F32, GRAD_NOISE = 1e-4, 3.0, 1e-6
UNIT32, UNIT64 = 2.0 ** -24, 2.0 ** -53
DRAWS = 3

# the operations whose floating-point result rounds (forward, backward and
# optimizer); every other operation's result is exact
ROUNDING_OPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "addmm", "mm", "bmm", "baddbmm",
    "addmv", "mv", "dot", "matmul", "linear", "sum", "mean", "var", "std",
    "var_mean", "cumsum", "prod", "exp", "expm1", "log", "log1p", "log2",
    "sqrt", "rsqrt", "reciprocal", "pow", "sigmoid", "tanh", "erf", "gelu",
    "silu", "leaky_relu", "elu", "softplus", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
    "sigmoid_backward", "tanh_backward", "gelu_backward",
    "leaky_relu_backward", "index_add", "scatter_add", "linalg_vector_norm",
    "norm", "native_layer_norm", "native_layer_norm_backward",
    "native_batch_norm", "native_batch_norm_backward", "addcmul", "addcdiv",
    "lerp", "embedding_dense_backward"))


_PRODUCTS = frozenset(("addmm", "mm", "bmm", "baddbmm", "addmv", "mv",
                       "dot", "matmul", "linear"))
_SUMS = frozenset(("sum", "mean", "var", "std", "var_mean", "prod",
                   "linalg_vector_norm", "norm"))


def _rounds(func, args) -> bool:
    name = func.overloadpacket.__name__.rstrip("_")
    if name == "scatter_reduce":
        return args[3] in ("sum", "mean", "prod")
    return name in ROUNDING_OPS


def _terms(func, args, out) -> int:
    """How many terms each result element sums: the inner length of a
    product, the reduced length of a sum, the source rows per target row
    of an index_add or scatter, the length of a softmax; 1 otherwise."""
    name = func.overloadpacket.__name__.rstrip("_")
    mats = [a for a in args if isinstance(a, torch.Tensor) and a.dim() >= 1]
    if not mats:
        return 1
    if name in _PRODUCTS:
        first = mats[1] if name in ("addmm", "baddbmm", "addmv") else mats[0]
        return first.shape[-1]
    if name in _SUMS and isinstance(out, torch.Tensor):
        return max(1, mats[0].numel() // max(out.numel(), 1))
    if name in ("index_add", "scatter_add", "scatter_reduce") and len(mats) > 1:
        dim = args[1]
        return max(1, -(-mats[-1].shape[dim] // max(mats[0].shape[dim], 1)))
    if name.startswith(("_softmax", "_log_softmax")):
        dim = next(a for a in args if type(a) is int)
        return mats[0].shape[dim]
    return 1


class RandomRounding(TorchDispatchMode):
    """The floating-point operands of every rounding operation (forward,
    backward, optimizer; see ROUNDING_OPS) multiplied by (1 + sqrt(n) *
    unit * U(-1, 1)), n the terms each result sums (`_terms`), and its
    result by (1 + unit * U(-1, 1)), elementwise, the noise drawn from
    `generator` on its device. In-place operations and views are left
    alone, so aliasing holds."""

    def __init__(self, generator: torch.Generator, unit: float = UNIT32):
        super().__init__()
        self.generator = generator
        self.unit = unit

    def _round(self, t, scale: float = 1.0):
        if (not isinstance(t, torch.Tensor) or not t.is_floating_point()
                or t.numel() == 0):
            return t
        e = torch.rand(t.shape, generator=self.generator, dtype=t.dtype,
                       device=t.device)
        return t * (1.0 + scale * self.unit * (2.0 * e - 1.0))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (not _rounds(func, args)
                or any(r.alias_info is not None for r in func._schema.returns)):
            return func(*args, **kwargs)
        # the operands at sqrt(n) of the unit for a sum of n terms: a fused
        # product or reduction rounds each partial sum inside it, a random
        # walk of n roundings of the running sum's size
        scale = math.sqrt(_terms(func, args, func(*args, **kwargs)))
        args, kwargs = tree_map(lambda t: self._round(t, scale),
                                (args, kwargs))
        return tree_map(self._round, func(*args, **kwargs))


class float64_default:
    """Context: float64 as torch's default float type (tensors a step
    creates inside itself), restored on exit."""

    def __enter__(self):
        self.old = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)

    def __exit__(self, *exc):
        torch.set_default_dtype(self.old)


def _grads(named) -> Dict[str, torch.Tensor]:
    """The gradients of the trained parameters (frozen ones, with
    requires_grad off, take no part)."""
    return {n: p.grad.detach().cpu().double() for n, p in named
            if p.requires_grad}


def rounding_spread(run_step: Callable[[torch.nn.Module], None],
                    model64: torch.nn.Module, g64: Dict[str, torch.Tensor],
                    draws: int = DRAWS, seed: int = 0,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, float]:
    """s per parameter: the largest ||g - g_64|| over `draws` runs of
    `run_step` (the float64 step, in place on a model on `device`, the
    CPU by default) on copies of the float64 model `model64` (its
    weights before the step) under RandomRounding. A float64 step is
    float64 on either device, so the card may run the draws."""
    device = torch.device("cpu") if device is None else device
    gen = torch.Generator(device=device).manual_seed(seed)
    spread = {n: 0.0 for n in g64}
    for _ in range(draws):
        m = copy.deepcopy(model64).to(device)
        with float64_default(), RandomRounding(gen):
            run_step(m)
        for n, g in _grads(m.named_parameters()).items():
            d = float((g - g64[n]).norm())
            if not math.isfinite(d):
                raise FloatingPointError(f"{n}: a randomly rounded float64 "
                                         f"step gave a non-finite gradient")
            spread[n] = max(spread[n], d)
    return spread


def output_spread(run: Callable[[], object], want, draws: int = DRAWS,
                  seed: int = 0, device: Optional[torch.device] = None
                  ) -> float:
    """The largest |run() - want| over the elements of `draws` calls of
    `run` (a float64 computation on `device`, the CPU by default; it
    returns a tensor or an array) under RandomRounding, against its
    unperturbed result `want`: what f32 rounding does to one element of
    the result, measured in float64 as for the gradients above."""
    device = torch.device("cpu") if device is None else device
    gen = torch.Generator(device=device).manual_seed(seed)
    want = torch.as_tensor(want, dtype=torch.float64).cpu()
    worst = 0.0
    for _ in range(draws):
        with float64_default(), RandomRounding(gen):
            got = torch.as_tensor(run())
        d = float((got.double().cpu() - want).abs().max())
        if not math.isfinite(d):
            raise FloatingPointError("a randomly rounded float64 run gave a "
                                     "non-finite result")
        worst = max(worst, d)
    return worst


def judge(named_cpu: Iterable, named_dev: Iterable, named_f64: Iterable,
          spread_of: Callable[[], Dict[str, float]],
          named_dev64: Optional[Callable[[], Iterable]] = None
          ) -> Tuple[str, List[str]]:
    """The check above on the `.grad` of three (or four) models after the
    same step: CPU f32, card f32, CPU float64 (and, called only when some
    tensor is beyond GRAD_RTOL, the card in float64; `spread_of()` gives
    s per parameter, also called only then). Returns (one log fragment,
    the names of the tensors that fail)."""
    g32, gd, g64 = (_grads(x) for x in (named_cpu, named_dev, named_f64))
    noise = GRAD_NOISE * max(float(g.norm()) for g in g64.values())
    rel, beyond, failed = {}, [], []
    for name in g32:
        if not g64[name].any():
            if gd[name].any():     # dead, or cancelled: the spread decides
                rel[name] = math.inf
                beyond.append(name)
            continue
        den = float(g32[name].norm())
        rel[name] = (float((gd[name] - g32[name]).norm()) / den if den
                     else math.inf)
        if rel[name] > GRAD_RTOL:
            beyond.append(name)
    w_rel = max(rel, key=rel.get)
    text = (f"gradients of {len(rel)} nonzero parameter tensors: largest "
            f"rel L2 err {rel[w_rel]:.3g} ({w_rel}); "
            f"{len(rel) - len(beyond)} within {GRAD_RTOL:g}")
    if not beyond:
        return text, failed
    spread = spread_of()
    gd64 = _grads(named_dev64()) if named_dev64 is not None else None
    r32, r64 = {}, {}
    for name in beyond:
        if not g64[name].any() and spread[name] == 0.0:
            failed.append(name)    # a dead layer with a card gradient
            continue
        r32[name] = float((gd[name] - g64[name]).norm()) / (
            GRAD_F32 * spread[name] + noise)
        if gd64 is not None:
            r64[name] = float((gd64[name] - g64[name]).norm()) / (
                (GRAD_F32 * spread[name] + noise) * UNIT64 / UNIT32)
        if r32[name] > 1.0 or r64.get(name, 0.0) > 1.0:
            failed.append(name)
    if not r32:
        return text + f"; dead layers with a card gradient: {failed}", failed
    w32 = max(r32, key=r32.get)
    text += (f", {len(beyond)} beyond it judged by float64: card f32 error "
             f"over its f32 rounding bound at most {r32[w32]:.3g} ({w32})")
    if r64:
        w64 = max(r64, key=r64.get)
        text += (f", card float64 vs CPU float64 over its float64 rounding "
                 f"bound at most {r64[w64]:.3g} ({w64})")
    text += (f" (bounds {GRAD_F32:g} x the spread of {DRAWS} float64 steps "
             f"under f32-sized random rounding + {GRAD_NOISE:g} of the "
             f"largest gradient norm)")
    return text, failed
