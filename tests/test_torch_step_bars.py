"""The stated rules by which the port's train-step tests hold an element that
leaves its bar for a reason of rounding, not of the step, and the rules' own
tests. Every other element keeps the bar of the test that calls them.

`weights_close`: the noise floor (weights after Adam steps). Adam's first
step moves a weight by lr x g / (|g| + eps). Where g is at its tensor's
noise floor (~1e-9), two rounding orders of the same gradient give moves
0.1-1 lr apart, or +-lr where its sign flips, whatever the step's other
numbers do. An element whose reference gradient, at a step it took, is at
most NOISE_FLOOR of that tensor's largest gradient at that step may leave
the test's bar; it is then held to 2 lr a step taken. At most
max(1, EXEMPT_SHARE x n) elements of an n-element tensor take this branch.
This is chip_smoke phase 14's rule, with the cap. A tensor whose whole
gradient is zero at the network's float32 resolution at every step taken
(every element within 2^-24 of the network's largest gradient: an
attention block's key bias, whose gradient softmax makes zero) has no
floor to measure against: it is all noise, and each of its elements is
held to 2 lr a step taken (the zero branch).

`grads_close` with `sums`: the cancelling sum. A gradient element that is
one sum of terms of both signs (the D's last bias: its conv has one output
channel, and its gradient is the sum of every logit's cotangent) carries
the rounding of that sum. Split on the CPU, the error was the sum's and
not the terms': at test_torch_osm_train.py's first step (98304 terms,
sum |t| = 1236 |sum t|) the port's float32 terms sat 3.2e-7 of their max
from its float64 step's and 2.4e-7 from JAX's, their float64 sum 5.6e-7 of
itself from the float64 step's gradient, while the port's reported float32
gradient sat 1.46e-3 of itself (1.18e-6) from that float64 sum: torch's
CPU reduction order in the conv's bias gradient (JAX's sum: 1.27e-4). The
card never runs that reduction. Such an element is held by three checks,
each at its own precision:
- the terms, element by element, within the test's bar (`rel` of their
  largest) of the reference's terms;
- the float64 sum of the port's float32 terms within SUM_REL of the
  float64 reference;
- the port's reported float32 value within the float32 recursive-summation
  bound (N - 1) 2^-24 sum |t| of that float64 sum, N terms, and within the
  realistic rounding sqrt(N) 2^-24 sum |t| (the first alone would pass a
  value of the wrong sign where the terms cancel 1000-fold).
It applies only to elements whose terms cancel, sum |t| >= CANCELS |sum t|,
decided from the numbers. A reference that is not the port's (JAX) is held
within REFERENCE_SUM_REL of the float64 reference; a reference that is the
port's float32 step by the last two checks on its own terms. Where the
float64 reference is itself zero at the terms' float32 resolution, |ref|
<= sqrt(N) 2^-24 sum |t| (a sum that cancels completely: an attention
block's key bias), SUM_REL of it is below any float32 rounding; there the
second check holds the float64 sum within that resolution of the
reference, and each side, JAX's included, takes the second and third
checks on its own terms.

`grads_close` with `kinks`: a LeakyReLU input within float32 rounding of
zero lands on one side of the kink in the port's step and on the other in
the reference's. The slope of one pixel then differs, and every weight
gradient upstream of it moves by that pixel's share. A tensor off its bar
is then held, at that same bar, against the reference's gradients
recomputed with each of its LeakyReLUs on the port's side, when every input
whose side differs is within KINK_ULPS float32 ulps of zero (of its call's
largest |x|), on both sides, and no call has more than max(1, KINK_SHARE x
n) of its n inputs on different sides.

`sums_within_bound`: a scalar downstream of a cancelling sum that both
sides compute from the same float32 terms (a spectral-norm conv divides
its weight by sigma = sum_ij u_i W_ij v_j, one sum that can cancel). The
first two checks then hold by construction; each side's sigma takes the
third. The calling test holds its scalar at its bar against the reference
recomputed with the port's sigmas.

Each use prints how many elements took each branch and the largest ratio to
its bound.
"""

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import pytest
import torch

#: a gradient element at most this share of its tensor's largest is at the noise floor
NOISE_FLOOR = 1e-4
#: at most max(1, EXEMPT_SHARE x n) elements of an n-element tensor on the noise-floor branch
EXEMPT_SHARE = 1e-3
#: the terms of a sum cancel when sum |t| >= CANCELS x |sum t|
CANCELS = 10.0
#: the float64 sum of the port's float32 terms against the float64 reference, relative
SUM_REL = 1e-4
#: a reference that is not the port's (JAX's float32 sum) against the float64 reference
REFERENCE_SUM_REL = 1e-3
#: float32's unit roundoff
U32 = 2.0 ** -24
#: a LeakyReLU input on different sides within this many float32 ulps of its call's largest |x|
KINK_ULPS = 16
#: at most max(1, KINK_SHARE x n) inputs on different sides among a call's n
KINK_SHARE = 1e-6


def _cap(n: int, share: float) -> int:
    return max(1, int(share * n))


def weights_close(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                  bar: Callable[[torch.Tensor], torch.Tensor], what,
                  grads: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
                  lr: float = 0.0) -> dict:
    """Weights after Adam steps against the reference's: every element within
    `bar(ref)` (the calling test's bar, a number or a tensor of ref's shape)
    except on the noise-floor branch, or the zero branch of a tensor whose
    whole gradient is zero at the network's float32 resolution at every
    step taken (module docstring). `grads` maps a name to the reference's
    gradient at each step taken (one network's, every parameter); `lr` is
    the largest learning rate of those steps. Returns and prints the
    branches' counts and their largest ratios to their bounds."""
    held = {"bar": [0, 0.0], "noise_floor": [0, 0.0], "zero": [0, 0.0]}
    names = {"noise_floor": [], "zero": []}
    grads = {n: [torch.as_tensor(g).double() for g in steps] for n, steps in (grads or {}).items()}
    steps_taken = max((len(s) for s in grads.values()), default=0)
    resolution = [U32 * max(s[i].abs().max().item() for s in grads.values())
                  for i in range(steps_taken)]
    for name, ref in want.items():
        ref = torch.as_tensor(ref).double()
        d = (torch.as_tensor(got[name]).double() - ref).abs()
        limit = torch.as_tensor(bar(ref), dtype=torch.float64).expand_as(d)
        off = d > limit
        steps = grads.get(name)
        if off.any():
            assert steps, (what, name, "off the bar with no reference gradient",
                           d[off].max().item(), limit[off].max().item())
            if all(g.abs().max() <= res for g, res in zip(steps, resolution)):
                branch, n_off = "zero", d.numel()
            else:
                quiet = torch.zeros_like(off)
                for g in steps:
                    g = g.reshape(d.shape).abs()
                    quiet |= g <= NOISE_FLOOR * g.max()
                loud = off & ~quiet
                assert not loud.any(), (what, name, "off the bar above the noise floor",
                                        d[loud].max().item(), limit[loud].max().item())
                branch, n_off = "noise_floor", int(off.sum())
                cap = _cap(d.numel(), EXEMPT_SHARE)
                assert n_off <= cap, (what, name, f"{n_off} elements at the noise floor, cap {cap}")
            bound = 2 * lr * len(steps)
            ratio = d[off].max().item() / bound
            assert ratio <= 1.0, (what, name, "beyond 2 lr a step", d[off].max().item(), bound)
            names[branch].append(name)
            held[branch][0] += n_off
            held[branch][1] = max(held[branch][1], ratio)
            if branch == "zero":
                continue
        on = ~off
        held["bar"][0] += int(on.sum())
        if on.any():
            ratio = (d[on] / limit[on].clamp_min(1e-300)).max().item()
            held["bar"][1] = max(held["bar"][1], ratio)
    _print(what, held, names)
    return held


@dataclasses.dataclass
class CancellingSum:
    """The terms of a gradient whose elements are sums: `terms` the port's
    float32 terms whose sums it reports ([N] for a one-element gradient,
    [N, n] for n elements, a column each), `ref_terms` the reference's,
    `exact` the float64 reference (the port's float64 step: a number or n
    of them), `ref_is_port` whether the reference is itself the port's
    float32 sum of `ref_terms`."""
    terms: torch.Tensor
    ref_terms: torch.Tensor
    exact: object
    ref_is_port: bool = False


@dataclasses.dataclass
class KinkSides:
    """The inputs of the D step's LeakyReLU calls in call order, the port's
    (`port`, float32, on the positive side where x > 0 as torch's
    leaky_relu takes it) and the reference's (`ref`, where x >= 0 as the
    JAX package's lrelu takes it), and `replay`: the reference's gradients
    recomputed with each of those calls on the port's side (called once,
    when a tensor needs them)."""
    port: List[torch.Tensor]
    ref: List[torch.Tensor]
    replay: Callable[[], Dict[str, torch.Tensor]]
    _replayed: Optional[Dict[str, torch.Tensor]] = None

    def replayed(self) -> Dict[str, torch.Tensor]:
        if self._replayed is None:
            self._replayed = self.replay()
        return self._replayed


def _resolution(t: torch.Tensor) -> torch.Tensor:
    """The realistic float32 rounding of the sums of the columns of `t`
    [N, n]: sqrt(N) 2^-24 sum |t|."""
    return math.sqrt(t.shape[0]) * U32 * t.abs().sum(0)


def _sum_checks(value: torch.Tensor, t: torch.Tensor, exact: torch.Tensor) -> tuple:
    """The second and third checks on one side: the float64 sums of the
    columns of `t` within SUM_REL of `exact` (within the terms' float32
    resolution of it where `exact` is zero at that resolution), and `value`
    within the recursive-summation bound and the realistic rounding of
    those sums. Returns (the larger ratio to its bound, the recursive bound
    over |sum t| where exact is not zero: how loose it is)."""
    s, res = t.sum(0), _resolution(t)
    zero = exact.abs() <= res
    r_sum = ((s - exact).abs() / torch.where(zero, res, SUM_REL * exact.abs())).max().item()
    recursive = (t.shape[0] - 1) * U32 * t.abs().sum(0)
    r_value = max(((value - s).abs() / recursive).max().item(),
                  ((value - s).abs() / res).max().item())
    assert r_sum <= 1.0, ("float64 sum of the terms", s.tolist(), exact.tolist())
    assert r_value <= 1.0, ("reported value beyond the summation bound", value.tolist(),
                            s.tolist(), recursive.tolist(), res.tolist())
    loose = (recursive / s.abs())[~zero].max().item() if (~zero).any() else 0.0
    return max(r_sum, r_value), loose


def _cancelling_sum(got: torch.Tensor, ref: torch.Tensor, rel: float, limit: float,
                    s: CancellingSum) -> tuple:
    n = got.numel()
    t, tr = s.terms.double().reshape(-1, n), s.ref_terms.double().reshape(-1, n)
    assert t.shape == tr.shape and t.shape[0] > 1, "a sum of terms for each element"
    g, r = got.double().flatten(), ref.double().flatten()
    exact = torch.as_tensor(s.exact, dtype=torch.float64).reshape(n)
    off = (g - r).abs() > limit
    cancels = t.abs().sum(0) >= CANCELS * t.sum(0).abs()
    assert cancels[off].all(), ("the terms do not cancel", t.abs().sum(0)[off & ~cancels].tolist(),
                                t.sum(0)[off & ~cancels].tolist())
    ratios = [((t - tr).abs().max() / (rel * tr.abs().max())).item()]
    assert ratios[0] <= 1.0, ("the terms off the reference's", ratios[0])
    ratio, loose = _sum_checks(g, t, exact)
    ratios.append(ratio)
    zero = exact.abs() <= _resolution(t)
    if s.ref_is_port:
        ratios.append(_sum_checks(r, tr, exact)[0])
    else:
        if zero.any():
            ratios.append(_sum_checks(r[zero], tr[:, zero], exact[zero])[0])
        if (~zero).any():
            ratios.append(((r - exact).abs() / (REFERENCE_SUM_REL * exact.abs()))[~zero]
                          .max().item())
            assert ratios[-1] <= 1.0, ("the reference off the float64 sum", r.tolist(),
                                       exact.tolist())
    return max(ratios), loose


def _kinks(name: str, got: torch.Tensor, limit: float, k: KinkSides) -> float:
    assert len(k.port) == len(k.ref), (len(k.port), len(k.ref))
    ratios, n_flips = [], 0
    for xp, xr in zip(k.port, k.ref):
        xp, xr = xp.double(), torch.as_tensor(xr).double()
        assert xp.shape == xr.shape, (xp.shape, xr.shape)
        flip = (xp > 0) != (xr >= 0)
        if not flip.any():
            continue
        n_flip, cap = int(flip.sum()), _cap(xr.numel(), KINK_SHARE)
        assert n_flip <= cap, (f"{n_flip} inputs on different sides in one call of "
                               f"{xr.numel()}, cap {cap}")
        ulps = KINK_ULPS * U32 * xr.abs().max().item()
        worst = max(xp[flip].abs().max().item(), xr[flip].abs().max().item())
        assert worst <= ulps, ("a side differs beyond float32 rounding of zero", worst, ulps)
        ratios.append(worst / ulps)
        n_flips += n_flip
    assert n_flips, "no LeakyReLU input on different sides"
    err = (got.double() - k.replayed()[name].double()).abs().max().item()
    ratios.append(err / limit)
    assert ratios[-1] <= 1.0, ("off the reference on the port's sides", ratios[-1])
    return max(ratios)


def grads_close(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], rel: float, what,
                floor: float = 0.0, sums: Optional[Dict[str, CancellingSum]] = None,
                kinks: Optional[KinkSides] = None) -> dict:
    """Each gradient within `rel` of its reference's largest element (+
    `floor`), element by element; a tensor off that bar only by one of the
    module docstring's rules: a cancelling sum (`sums[name]`) or a
    LeakyReLU kink (`kinks`). Returns and prints the branches' counts
    (elements) and their largest ratios to their bounds."""
    assert set(want) <= set(got), (what, sorted(set(want) - set(got)))
    held = {"bar": [0, 0.0], "cancelling_sum": [0, 0.0], "kink": [0, 0.0]}
    names = {"cancelling_sum": [], "kink": []}
    loose = 0.0
    for name, ref in want.items():
        ref, g = torch.as_tensor(ref), torch.as_tensor(got[name])
        limit = rel * ref.abs().max().item() + floor
        err = (g.double() - ref.double()).abs().max().item()
        if err <= limit:
            held["bar"][0] += ref.numel()
            held["bar"][1] = max(held["bar"][1], err / limit if limit else 0.0)
            continue
        if sums is not None and name in sums:
            branch = "cancelling_sum"
            ratio, slack = _cancelling_sum(g, ref, rel, limit, sums[name])
            loose = max(loose, slack)
        elif kinks is not None and name in kinks.replayed():
            branch, ratio = "kink", _kinks(name, g, limit, kinks)
        else:
            raise AssertionError((what, name, "off the bar", err / max(limit, 1e-300)))
        names[branch].append(name)
        held[branch][0] += ref.numel()
        held[branch][1] = max(held[branch][1], ratio)
    _print(what, held, names, f"; the recursive bound {loose:.3g} x |sum t|" if loose else "")
    return held


def sums_within_bound(values: Sequence[float], terms: Sequence[torch.Tensor], what) -> float:
    """One-element sums (`values`, each side's float32 result) of terms that
    both sides share (`terms`: each sum's float32 terms, e.g. a spectral
    norm's u_i W_ij v_j): each value within the summation bounds of the
    float64 sum of its terms, and at least one sum cancelling. Returns and
    prints the largest ratio to its bound."""
    ratios, cancel = [], 0.0
    for value, t in zip(values, terms):
        t = t.double().reshape(-1, 1)
        exact = t.sum(0)
        cancel = max(cancel, (t.abs().sum() / exact.abs()).item())
        ratios.append(_sum_checks(torch.tensor([float(value)], dtype=torch.float64), t, exact)[0])
    assert cancel >= CANCELS, (what, "no sum cancels", cancel)
    print(f"{what}: cancelling_sum {len(ratios)} sums, largest sum |t| / |sum t| {cancel:.3g}, "
          f"largest ratio to its bound {max(ratios):.3g}")
    return max(ratios)


def _print(what, held: dict, names: dict, extra: str = "") -> None:
    print(f"{what}: " + "; ".join(
        f"{branch} {n} elements" + (f" of {names[branch]}" if names.get(branch) else "")
        + f", largest ratio to its bound {r:.3g}" for branch, (n, r) in held.items()) + extra)


# -- what the rules read, recorded from the steps -------------------------------


@contextlib.contextmanager
def logit_terms_of(model):
    """While active, each per-pixel D logit tensor that the model's GAN loss
    receives for D's own update is recorded as {"z": logits, "t": their
    cotangent, float32 as the backward sees it}, in call order (real, then
    fake, a micro-batch at a time); yields the list. The OSM D's object
    logits ([N, 2, 2, 1]) are not recorded."""
    rec, gan = [], model.cri_gan

    def cri_gan(logits, target_is_real, is_disc=False):
        if is_disc and logits.requires_grad and logits.shape[1] > 2:
            slot = {"z": logits.detach().clone()}
            logits.register_hook(lambda g: slot.__setitem__("t", g.detach().clone()))
            rec.append(slot)
        return gan(logits, target_is_real, is_disc)

    model.cri_gan = cri_gan
    try:
        yield rec
    finally:
        model.cri_gan = gan


def logit_terms(rec: List[dict]) -> torch.Tensor:
    """The recorded cotangents, flattened in call order."""
    return torch.cat([slot["t"].flatten() for slot in rec])


def jax_logit_terms(gan, real, fake):
    """JAX's cotangents of its D's per-pixel logits `real` and `fake` in
    the D loss (gan: the model's cri_gan), flattened in the port's order."""
    import jax
    import jax.numpy as jnp

    t_real = jax.grad(lambda z: gan(z, True, is_disc=True))(real)
    t_fake = jax.grad(lambda z: gan(z, False, is_disc=True))(fake)
    return jnp.concatenate([t_real.ravel(), t_fake.ravel()])


def adam_grads(mus: Sequence[Dict[str, torch.Tensor]], b1: float) -> Dict[str, List[torch.Tensor]]:
    """The gradient each Adam step took, from the first moments after steps
    1..t (optax's mu_t = b1 mu_{t-1} + (1 - b1) g_t, mu_0 = 0), in float64:
    {name: [g_1, ..., g_t]}."""
    out, prev = {}, {}
    for mu in mus:
        for name, m in mu.items():
            m = torch.as_tensor(m).double()
            g = (m - b1 * prev.get(name, torch.zeros_like(m))) / (1.0 - b1)
            out.setdefault(name, []).append(g)
            prev[name] = m
    return out


def optax_mu(opt_state):
    """The first-moment tree of the optax Adam state inside `opt_state`."""
    from flax import serialization

    def find(tree):
        if isinstance(tree, dict):
            if {"count", "mu", "nu"} <= set(tree):
                return tree["mu"]
            for value in tree.values():
                found = find(value)
                if found is not None:
                    return found
        return None

    mu = find(serialization.to_state_dict(opt_state))
    assert mu is not None, "no optax Adam state"
    return mu


@contextlib.contextmanager
def lrelu_sides():
    """Records the input of every U-Net D LeakyReLU call of the port while
    active, in call order; yields the record."""
    from satlas_sr_tpu_torch.archs import discriminator as dmod

    orig, record = dmod._lrelu, []

    def lrelu(x):
        record.append(x.detach().clone())
        return orig(x)

    dmod._lrelu = lrelu
    try:
        yield record
    finally:
        dmod._lrelu = orig


@contextlib.contextmanager
def jax_lrelu_sides(replay: Optional[Sequence[np.ndarray]] = None):
    """While active (around the tracing of a JAX function), records the
    input of every JAX U-Net D LeakyReLU call; with `replay` (booleans, one
    array a call in call order: the port's sides), each call takes its side
    of the kink from it instead of from its own input. Yields the record
    (traced arrays: return them from the traced function)."""
    import jax.numpy as jnp
    from satlas_sr_tpu.archs import discriminator as jdmod

    orig, record = jdmod.lrelu, []

    def lrelu(x, negative_slope=0.2):
        if replay is None:
            y = orig(x, negative_slope)
        else:
            side = jnp.asarray(replay[len(record)])
            assert side.shape == x.shape, (side.shape, x.shape)
            y = jnp.where(side, x, negative_slope * x)
        record.append(x)
        return y

    jdmod.lrelu = lrelu
    try:
        yield record
    finally:
        jdmod.lrelu = orig


@contextlib.contextmanager
def jax_sigmas(replay: Optional[Sequence[float]] = None):
    """While active (around the tracing of a JAX function), records the sigma
    of every JAX SNConv call (its one `jnp.dot`); with `replay`, the k-th
    call takes replay[k mod len(replay)] as its sigma instead (one D
    forward a cycle; a constant: no gradient flows through it to the
    kernel). Yields the record (traced arrays)."""
    import jax.numpy as jnp
    from satlas_sr_tpu.ops import spectral_norm as jsn

    record = []

    class Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def dot(a, b):
            sigma = jnp.dot(a, b)
            if replay is not None:
                sigma = jnp.asarray(replay[len(record) % len(replay)], dtype=sigma.dtype)
            record.append(sigma)
            return sigma

    jsn.jnp = Jnp()
    try:
        yield record
    finally:
        jsn.jnp = jnp


@contextlib.contextmanager
def jax_output_cotangents(select: Callable[[object], bool]):
    """While active (around the tracing of a jax.grad), the output of each
    flax module call for which select(module) holds passes through an
    identity whose backward hands its cotangent out through
    jax.debug.callback; yields {slot (trace order): torch tensor}, filled
    when the traced computation runs (read it after jax.effects_barrier())."""
    import flax.linen as nn
    import jax

    got, slots = {}, [0]

    def tap(y):
        slot = slots[0]
        slots[0] += 1

        @jax.custom_vjp
        def ident(y):
            return y

        def bwd(_, g):
            jax.debug.callback(lambda a: got.__setitem__(slot, torch.from_numpy(np.array(a))), g)
            return (g,)

        ident.defvjp(lambda y: (y, None), bwd)
        return ident(y)

    def interceptor(next_fun, args, kwargs, context):
        y = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and select(context.module):
            y = tap(y)
        return y

    with nn.intercept_methods(interceptor):
        yield got


# -- the rules' own tests ----------------------------------------------------------

LR = 1e-4


def _bar(ref):
    return 1e-4 * ref.abs().max() + 1e-6


def _weights(n=4000, seed=0):
    gen = torch.Generator().manual_seed(seed)
    want = torch.randn(n, generator=gen, dtype=torch.float64) * 0.05
    grad = torch.randn(n, generator=gen, dtype=torch.float64) * 1e-3
    grad[7] = 1e-9  # one element at the noise floor
    return want, grad


def test_weights_within_their_bar_take_no_branch():
    want, grad = _weights()
    got = want + 0.5e-6
    held = weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [grad]}, LR)
    assert held["bar"][0] == want.numel() and held["noise_floor"][0] == 0


def test_noise_floor_element_held_to_two_lr_a_step():
    want, grad = _weights()
    got = want.clone()
    got[7] += 1.9 * LR
    held = weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [grad]}, LR)
    assert held["noise_floor"][0] == 1 and 0.9 < held["noise_floor"][1] <= 1.0
    got[7] = want[7] + 2.1 * LR
    with pytest.raises(AssertionError, match="beyond 2 lr"):
        weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [grad]}, LR)
    got[7] = want[7] + 3 * LR  # within 2 lr a step over two steps
    held = weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [grad, grad]}, LR)
    assert held["noise_floor"][0] == 1


@pytest.mark.parametrize("factor", [2.0, 100.0])
def test_element_above_the_floor_off_its_bar_is_rejected(factor):
    want, grad = _weights()
    got = want.clone()
    got[3] += factor * _bar(want).item()  # grad[3] is ~1e-3: above the floor
    with pytest.raises(AssertionError, match="above the noise floor"):
        weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [grad]}, LR)


def test_weights_without_gradients_take_no_noise_floor_branch():
    want, _ = _weights()
    got = want.clone()
    got[7] += 2 * _bar(want).item()
    with pytest.raises(AssertionError, match="no reference gradient"):
        weights_close({"u": got}, {"u": want}, _bar, "t")


def test_more_noise_floor_elements_than_the_cap_are_rejected():
    want, grad = _weights()
    cap = _cap(want.numel(), EXEMPT_SHARE)
    quiet = torch.arange(cap + 1) * 11
    grad[quiet] = 1e-10
    got = want.clone()
    got[quiet[:cap]] += LR
    held = weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [grad]}, LR)
    assert held["noise_floor"][0] == cap
    got[quiet] = want[quiet] + LR
    with pytest.raises(AssertionError, match="cap"):
        weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [grad]}, LR)


def test_a_floor_at_one_step_exempts_the_element():
    want, grad = _weights()
    loud = grad.clone()
    loud[7] = 1e-3
    got = want.clone()
    got[7] += 2.5 * LR
    held = weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [loud, grad]}, LR)
    assert held["noise_floor"][0] == 1
    with pytest.raises(AssertionError, match="above the noise floor"):
        weights_close({"w": got}, {"w": want}, _bar, "t", {"w": [loud, loud]}, LR)


def test_adam_grads_inverts_the_first_moment():
    gen = torch.Generator().manual_seed(1)
    g = [torch.randn(5, generator=gen, dtype=torch.float64) for _ in range(3)]
    mu, mus = torch.zeros(5, dtype=torch.float64), []
    for step in g:
        mu = 0.9 * mu + 0.1 * step
        mus.append({"w": mu.clone()})
    for got, want in zip(adam_grads(mus, 0.9)["w"], g):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _zero_gradient_tensor():
    want, grad = _weights()
    key = torch.full((16,), 0.01, dtype=torch.float64)
    noise = torch.randn(16, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    return want, grad, key, noise


def test_weights_of_a_zero_gradient_tensor_held_to_two_lr_a_step():
    want, grad, key, noise = _zero_gradient_tensor()
    grads = {"w": [grad], "k": [noise * 1e-10]}  # ~1e-10 against a largest gradient of ~3e-3
    got = {"w": want, "k": key + 1.5 * LR * noise.sign()}
    held = weights_close(got, {"w": want, "k": key}, _bar, "t", grads, LR)
    assert held["zero"][0] == 16
    got["k"] = key + 2.5 * LR
    with pytest.raises(AssertionError, match="beyond 2 lr"):
        weights_close(got, {"w": want, "k": key}, _bar, "t", grads, LR)
    grads["k"] = [noise * 1e-6]  # above the resolution: per element, capped
    got["k"] = key + 1.5 * LR * noise.sign()
    with pytest.raises(AssertionError, match="noise floor"):
        weights_close(got, {"w": want, "k": key}, _bar, "t", grads, LR)


def test_a_tensor_zero_at_one_step_only_takes_no_zero_branch():
    want, grad, key, noise = _zero_gradient_tensor()
    grads = {"w": [grad, grad], "k": [noise * 1e-10, noise * 1e-3]}  # loud at step 2
    got = {"w": want, "k": key + 1.5 * LR * noise.sign()}
    with pytest.raises(AssertionError, match="above the noise floor"):
        weights_close(got, {"w": want, "k": key}, _bar, "t", grads, LR)
    grads["k"] = [noise * 1e-10, noise * 1e-10]  # zero at both: the zero branch
    assert weights_close(got, {"w": want, "k": key}, _bar, "t", grads, LR)["zero"][0] == 16


def _sum_case(n=4096, seed=0):
    """A cancelling sum: float32 terms, their float64 sum, and a float32
    value summed in another order."""
    gen = torch.Generator().manual_seed(seed)
    t = (torch.randn(n, generator=gen, dtype=torch.float64) * 1e-4).float()
    t[0] -= t.double().sum().float() * 0.999  # cancel to ~0.1% of the raw sum
    exact = t.double().sum().item()
    value = t.flip(0).cumsum(0)[-1].reshape(1)  # float32, sequential
    return t, exact, value


def test_cancelling_sum_takes_its_branch():
    t, exact, value = _sum_case()
    ref = torch.tensor([exact], dtype=torch.float32) * (1 + 5e-4)  # JAX's float32 sum, 5e-4 off
    held = grads_close({"b": value}, {"b": ref}, 1e-4, "t",
                       sums={"b": CancellingSum(t, t + 1e-12, exact)})
    assert held["cancelling_sum"][0] == 1


def test_cancelling_sum_rejects_terms_off_the_reference():
    t, exact, value = _sum_case()
    ref_terms = t.clone()
    ref_terms[5] += 2 * 1e-4 * t.abs().max()  # 2x the terms' bar
    ref = torch.tensor([exact * (1 + 5e-4)], dtype=torch.float32)
    with pytest.raises(AssertionError, match="terms off"):
        grads_close({"b": value}, {"b": ref}, 1e-4, "t",
                    sums={"b": CancellingSum(t, ref_terms, exact)})


def test_cancelling_sum_rejects_a_sum_off_the_float64_reference():
    t, exact, value = _sum_case()
    ref = torch.tensor([exact * (1 + 5e-4)], dtype=torch.float32)
    with pytest.raises(AssertionError, match="float64 sum of the terms"):
        grads_close({"b": value}, {"b": ref}, 1e-4, "t",
                    sums={"b": CancellingSum(t, t, exact * (1 + 2 * SUM_REL))})


@pytest.mark.parametrize("bound", ["recursive", "realistic"])
def test_cancelling_sum_rejects_a_value_beyond_the_summation_bound(bound):
    t, exact, _ = _sum_case()
    a = t.double().abs().sum().item()
    off = (t.numel() - 1) * U32 * a if bound == "recursive" else math.sqrt(t.numel()) * U32 * a
    assert off < abs(exact) or bound == "recursive"  # the realistic one keeps the sign
    value = torch.tensor([exact + 2 * off], dtype=torch.float32)
    ref = torch.tensor([exact * (1 + 5e-4)], dtype=torch.float32)
    with pytest.raises(AssertionError, match="summation bound"):
        grads_close({"b": value}, {"b": ref}, 1e-4, "t", sums={"b": CancellingSum(t, t, exact)})


def test_cancelling_sum_rejects_terms_that_do_not_cancel_and_a_far_reference():
    t, exact, value = _sum_case()
    plain = t.abs()
    s = plain.double().sum().item()
    with pytest.raises(AssertionError, match="do not cancel"):
        grads_close({"b": plain.sum().reshape(1) * (1 + 1e-3)}, {"b": torch.tensor([s])}, 1e-4,
                    "t", sums={"b": CancellingSum(plain, plain, s)})
    with pytest.raises(AssertionError, match="reference off"):
        grads_close({"b": value}, {"b": torch.tensor([exact * (1 + 2e-3)])}, 1e-4, "t",
                    sums={"b": CancellingSum(t, t, exact)})


def _zero_sums(n=512, cols=4, seed=4):
    """Columns of float32 terms whose exact sums are zero (each column and
    its negation, shuffled), the float64 reference a rounding residue."""
    gen = torch.Generator().manual_seed(seed)
    half = torch.randn(n // 2, cols, generator=gen) * 1e-4
    t = torch.cat([half, -half])[torch.randperm(n, generator=gen)]
    t[3] += 3e-12  # a residue, as float32 terms of a structural zero carry
    return t, t.double().sum(0)


def test_a_sum_that_cancels_completely_is_held_at_its_resolution():
    t, exact = _zero_sums()
    port, ref = t.sum(0), t.flip(0).sum(0)  # two float32 orders
    assert (port - ref).abs().max() > 1e-4 * ref.abs().max()  # off the plain bar
    held = grads_close({"k": port}, {"k": ref}, 1e-4, "t",
                       sums={"k": CancellingSum(t, t.clone(), exact)})
    assert held["cancelling_sum"][0] == t.shape[1]
    res = _resolution(t.double())
    with pytest.raises(AssertionError, match="summation bound"):
        grads_close({"k": port + 2 * res.float()}, {"k": ref}, 1e-4, "t",
                    sums={"k": CancellingSum(t, t.clone(), exact)})
    with pytest.raises(AssertionError, match="summation bound"):  # JAX's side too
        grads_close({"k": port}, {"k": ref + 2 * res.float()}, 1e-4, "t",
                    sums={"k": CancellingSum(t, t.clone(), exact)})
    with pytest.raises(AssertionError, match="float64 sum of the terms"):
        grads_close({"k": port}, {"k": ref}, 1e-4, "t",
                    sums={"k": CancellingSum(t, t.clone(), exact + 2 * res)})


def test_without_a_rule_an_element_off_its_bar_fails():
    ref = torch.ones(10)
    got = ref.clone()
    got[2] += 2e-4
    with pytest.raises(AssertionError, match="off the bar"):
        grads_close({"w": got}, {"w": ref}, 1e-4, "t")


def _kink_case(offset=6e-8, n_flips=1):
    """The port's and the reference's inputs of one LeakyReLU call, on
    different sides at `n_flips` inputs `offset` from zero, and gradients:
    the reference's recomputed on the port's sides equal to the port's."""
    gen = torch.Generator().manual_seed(2)
    xr = torch.randn(2, 32, 32, 16, generator=gen)
    xr.view(-1)[:n_flips] = -offset
    xp = xr.clone()
    xp.view(-1)[:n_flips] = offset
    port = torch.randn(64, generator=gen)
    ref = port.clone()
    ref[:8] += 4e-4 * port.abs().max()
    return port, ref, KinkSides([xp], [xr], lambda: {"w": port.clone()})


def test_kink_branch_holds_a_tensor_against_the_reference_on_the_port_sides():
    port, ref, kinks = _kink_case()
    held = grads_close({"w": port}, {"w": ref}, 1e-4, "t", kinks=kinks)
    assert held["kink"][0] == port.numel()


def test_kink_branch_rejects_a_side_beyond_rounding_and_too_many():
    port, ref, kinks = _kink_case(offset=1e-4)
    with pytest.raises(AssertionError, match="beyond float32 rounding"):
        grads_close({"w": port}, {"w": ref}, 1e-4, "t", kinks=kinks)
    port, ref, kinks = _kink_case(n_flips=2)
    with pytest.raises(AssertionError, match="different sides in one call"):
        grads_close({"w": port}, {"w": ref}, 1e-4, "t", kinks=kinks)


def test_kink_branch_rejects_a_gradient_off_the_reference_on_the_port_sides():
    port, ref, kinks = _kink_case()
    kinks.replayed()["w"][3] += 2 * 1e-4 * ref.abs().max().item()
    with pytest.raises(AssertionError, match="port's sides"):
        grads_close({"w": port}, {"w": ref}, 1e-4, "t", kinks=kinks)
    port, ref, kinks = _kink_case(n_flips=0)
    with pytest.raises(AssertionError, match="no LeakyReLU input"):
        grads_close({"w": port}, {"w": ref}, 1e-4, "t", kinks=kinks)


def test_jax_lrelu_sides_records_and_replays_the_port_sides():
    import jax
    import jax.numpy as jnp

    from satlas_sr_tpu.archs.discriminator import UNetDiscriminatorSN as JaxUNet
    from satlas_sr_tpu.utils import torch_io as jax_torch_io
    from satlas_sr_tpu_torch.archs.discriminator import UNetDiscriminatorSN

    port = UNetDiscriminatorSN(3, 4, seed=0, device="cpu")
    variables = jax_torch_io.unet_disc_from_torch(
        {k: v.numpy() for k, v in port.state_dict().items()})
    x = np.random.RandomState(0).rand(1, 16, 16, 3).astype(np.float32)
    with lrelu_sides() as rec:
        want = port(torch.from_numpy(x))

    def forward(sides):
        with jax_lrelu_sides(sides) as record:
            return JaxUNet(num_in_ch=3, num_feat=4).apply(variables, jnp.asarray(x)), record

    out, xs = jax.jit(lambda: forward(None))()
    assert len(rec) == len(xs) == 9
    for a, b in [(want.detach(), out)] + list(zip(rec, xs)):  # within 1e-4 of each's max
        assert np.abs(np.asarray(b) - a.numpy()).max() <= 1e-4 * a.abs().max().item()
    flipped = [np.asarray(r.numpy() <= 0) for r in rec]
    other, _ = jax.jit(lambda: forward(flipped))()
    assert np.isfinite(np.asarray(other)).all()
    assert not np.allclose(np.asarray(other), np.asarray(out))


def test_jax_sigmas_records_and_replays_the_port_sigmas():
    import jax
    import jax.numpy as jnp

    from satlas_sr_tpu.archs.discriminator import UNetDiscriminatorSN as JaxUNet
    from satlas_sr_tpu.utils import torch_io as jax_torch_io
    from satlas_sr_tpu_torch.archs.discriminator import UNetDiscriminatorSN

    port = UNetDiscriminatorSN(3, 4, seed=0, device="cpu")
    sd = port.state_dict()
    variables = jax_torch_io.unet_disc_from_torch({k: v.numpy() for k, v in sd.items()})
    x = jnp.asarray(np.random.RandomState(0).rand(1, 16, 16, 3).astype(np.float32))
    sigmas = [torch.dot(sd[f"conv{i}.weight_u"],
                        sd[f"conv{i}.weight_orig"].flatten(1) @ sd[f"conv{i}.weight_v"]).item()
              for i in range(1, 9)]

    def forward(replay):
        with jax_sigmas(replay) as record:
            return JaxUNet(num_in_ch=3, num_feat=4).apply(variables, x), record

    out, got = jax.jit(lambda: forward(None))()
    np.testing.assert_allclose(np.asarray(got), sigmas, rtol=1e-5)
    doubled, again = jax.jit(lambda: forward([2 * s for s in sigmas]))()
    np.testing.assert_allclose(np.asarray(again), [2 * s for s in sigmas], rtol=1e-7)
    assert not np.allclose(np.asarray(doubled), np.asarray(out))


def test_sums_within_bound_rejects_a_sigma_off_its_sum_and_sums_that_do_not_cancel():
    t, exact, value = _sum_case()
    assert sums_within_bound([value.item()], [t], "t") <= 1.0
    off = math.sqrt(t.numel()) * U32 * t.double().abs().sum().item()
    with pytest.raises(AssertionError, match="summation bound"):
        sums_within_bound([exact + 2 * off], [t], "t")
    with pytest.raises(AssertionError, match="no sum cancels"):
        sums_within_bound([t.abs().double().sum().item()], [t.abs()], "t")


def test_jax_output_cotangents_hands_out_a_module_output_cotangent():
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    class Two(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(3, name="last")(nn.Dense(4, name="first")(x))

    net = Two()
    x = jnp.ones((2, 5))
    params = net.init(jax.random.PRNGKey(0), x)

    def loss(p):
        y = net.apply(p, x)
        return (y ** 2).sum(), y

    with jax_output_cotangents(lambda m: m.name == "last") as got:
        grads, y = jax.jit(jax.grad(loss, has_aux=True))(params)
    jax.effects_barrier()
    assert sorted(got) == [0]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(2 * y), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(grads["params"]["last"]["bias"]),
                               got[0].numpy().sum(0), rtol=1e-6)
