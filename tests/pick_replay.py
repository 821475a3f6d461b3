"""Records the neighbour picks of a `PVCNN2` forward (its SA levels' FPS and
ball queries, its FP levels' 3-NN) and hands them to another run of the
same net, so that a card run and a float64 CPU run compute on the same
picks: a pick that two roundings decide apart at a tie, and the 3-NN
weights 1 / (d + 1e-8) that read the rounding noise of a point's zero
distance to itself, would otherwise part the runs.  Imports neither JAX
nor the JAX package: the card tests and `chip_smoke.py` share it."""

import contextlib

import torch

from slide_tpu_torch.models import pvcnn
from slide_tpu_torch.nn import neighborhood

_NAMES = ((pvcnn, "furthest_point_sample"), (pvcnn, "three_nn"), (neighborhood, "ball_query"))


@contextlib.contextmanager
def _patched(make):
    saved = [getattr(mod, name) for mod, name in _NAMES]
    try:
        for (mod, name), real in zip(_NAMES, saved):
            setattr(mod, name, make(name, real))
        yield
    finally:
        for (mod, name), real in zip(_NAMES, saved):
            setattr(mod, name, real)


@contextlib.contextmanager
def recording_picks(calls: list):
    """Within: every FPS, ball query and 3-NN of the PVCNN2 forward appends
    (name, its outputs on the host) to `calls`."""
    def make(name, real):
        def run(*args, **kwargs):
            out = real(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((name, [t.detach().cpu() for t in outs]))
            return out
        return run

    with _patched(make):
        yield calls


@contextlib.contextmanager
def replaying_picks(calls: list, seen: dict):
    """Within: each FPS, ball query and 3-NN returns the recorded call's
    picks (distances in the run's dtype) on the run's device, in order;
    `seen["calls"]` counts them."""
    it = iter(calls)
    seen["calls"] = 0

    def make(name, real):
        def run(*args, **kwargs):
            got, outs = next(it)
            if got != name:
                raise AssertionError(f"replay: expected {got}, the run called {name}")
            seen["calls"] += 1
            dev = args[0].device
            dtype = args[0].dtype
            outs = [t.to(dev, dtype) if t.is_floating_point() else t.to(dev) for t in outs]
            return outs[0] if len(outs) == 1 else tuple(outs)
        return run

    with _patched(make):
        yield seen


def pvcnn2_picks_replayed(net, args_card, args_ref, ref_device, ref_dtype):
    """`net` on the card on `args_card`, then a copy on `ref_device` in
    `ref_dtype` on `args_ref` with the card's picks: (card output, reference
    output, the number of picks replayed), both on the host in float64."""
    import copy
    calls = []
    with torch.no_grad(), recording_picks(calls):
        card = net(*args_card).double().cpu()
    ref_net = copy.deepcopy(net).to(ref_device, ref_dtype)
    seen = {}
    with torch.no_grad(), replaying_picks(calls, seen):
        ref = ref_net(*args_ref).double().cpu()
    if seen["calls"] != len(calls):
        raise AssertionError(f"replay: {seen['calls']} of {len(calls)} picks used")
    return card, ref, len(calls)
