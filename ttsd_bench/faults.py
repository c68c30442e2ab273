"""Faults planted underneath the timed path, for the check's own proof: each
breaks the port's decode step (static engine and pool alike) as one of the
contract's faults would, and a run over it must read ``correct`` false.
``python -m ttsd_bench.readings --fault <how>`` reads them on the card at a
cell's own size; ``ttsd_bench/tests`` reads them on the CPU.

* ``unchanged``: the step leaves the model's state as it was: past the
  first decode step after a prefill, the decode forward hands on the
  hidden state that step produced, so the same state feeds every later
  step;
* ``half_batch``: the second half of the rows left out of the decode
  step's model forward, taking the first half's hidden states;
* ``token``: one channel's token altered where it is sampled.

``unchanged`` and ``half_batch`` are planted in ``AsteroidLM.backbone``,
in device operations on tensors that outlive the call, so a CUDA graph
captured over the step replays them too.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "token")


def _patches(how: str) -> list:
    """(owner, attribute, replacement) triples that plant ``how``."""
    import torch
    from moss_ttsd_torch.decode import continuous, engine
    from moss_ttsd_torch.models import lm
    if how == "unchanged":
        orig = lm.AsteroidLM.backbone
        held = {}       # (model, decode shape, device) -> [state, is set]

        def backbone(self, ids, *a, **k):
            h, cache = orig(self, ids, *a, **k)
            if ids.shape[1] != 1:       # a prefill: the next step sets it
                for key, (_, is_set) in held.items():
                    if key[0] == id(self):
                        is_set.zero_()
                return h, cache
            key = (id(self), tuple(h.shape), h.device)
            if key not in held:
                held[key] = [h.clone(), torch.ones((), dtype=torch.bool,
                                                   device=h.device)]
                return h, cache
            state, is_set = held[key]
            state.copy_(torch.where(is_set, state, h))
            is_set.fill_(True)
            return state.clone(), cache
        return [(lm.AsteroidLM, "backbone", backbone)]
    if how == "half_batch":
        orig = lm.AsteroidLM.backbone

        def backbone(self, ids, *a, **k):
            h, cache = orig(self, ids, *a, **k)
            B = h.shape[0]
            if ids.shape[1] == 1 and B > 1:
                h = h.clone()
                h[B - B // 2:] = h[:B // 2]
            return h, cache
        return [(lm.AsteroidLM, "backbone", backbone)]
    if how == "token":
        orig = engine.sample_channels

        def sample(*a, **k):
            t = orig(*a, **k)
            t[:, 1] = (t[:, 1] + 1) % 32
            return t
        return [(engine, "sample_channels", sample),
                (continuous, "sample_channels", sample)]
    raise ValueError(f"unknown fault {how!r}; one of {FAULTS}")


@contextlib.contextmanager
def planted(how: str):
    """The port with ``how`` planted, restored on exit."""
    patches = _patches(how)
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        yield
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)
