"""The one traffic generator: scripts, budgets and arrival times from a
traffic file's parameters and the run's seed.

Every seed gets the same multiset of sizes and gaps: each drawn quantity
takes the evenly spaced quantiles of its distribution (uniform,
log-uniform, or exponential for the gaps between arrivals). The closed
loop's seed shuffles its batches' budgets and prompt lengths. The open
loop's schedule (which gap, budget, prompt length and voice comes when)
is one fixed shuffle, the same for every seed: its tail latency hangs on
how bursts of long requests line up, and a schedule drawn anew for every
seed moved the 90th percentile of TTFA by up to 2x between seeds. Its seed
changes the text, the weights and the voices.

Scripts are two-speaker ``[S1]``/``[S2]`` dialogue of plain words, cut to an
exact prompt length in tokens (system prompt and template included).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from .reference import prompt

WORDS = ("well so we should talk about the new plan for the trip tomorrow "
         "morning i think it rains but maybe not and you said the train "
         "leaves at nine which is early for me honestly yes right okay sure "
         "do you remember last summer when we missed it completely funny "
         "story though what about coffee first then we can walk there "
         "slowly and catch up on everything that happened this week").split()


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def quantiles(kind: str, lo: float, hi: float, n: int) -> np.ndarray:
    """n evenly spaced quantiles (i + 0.5) / n of a uniform or log-uniform
    distribution on [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    if kind == "uniform":
        return lo + u * (hi - lo)
    if kind == "loguniform":
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    raise ValueError(f"unknown distribution {kind!r}")


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """n evenly spaced quantiles of the exponential gap of a Poisson
    process at ``rate`` per second."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def script(tokens: int, r: np.random.Generator) -> str:
    """A dialogue whose prompt is exactly ``tokens`` tokens long."""
    n = tokens - prompt.overhead_tokens()
    if n < 6:
        raise ValueError(f"a {tokens}-token prompt leaves no room for a script")
    parts, used, speaker = [], 0, 1
    while used < n:
        tag = f"[S{speaker}]"
        parts.append(tag)
        used += 1
        for _ in range(int(r.integers(4, 14))):
            w = WORDS[int(r.integers(len(WORDS)))] + " "
            if used + len(w) > n:
                break
            parts.append(w)
            used += len(w)
        speaker = 3 - speaker
        if n - used < 8:
            parts.append("." * (n - used))
            used = n
    text = "".join(parts)
    assert prompt.prompt_tokens(text) == tokens, (tokens, text)
    return text


def batches(traffic: dict, seed: int, count: int) -> List[dict]:
    """``count`` batches of the closed-loop mix: each {"scripts": [...],
    "steps": budget}. A cycle of ``cycle`` budgets at the quantiles of
    ``budget_steps`` repeats in a new order; every batch's prompts take
    the ``batch`` quantiles of ``prompt_tokens`` in a new order."""
    r = rng(seed, 1)
    B, cyc = traffic["batch"], traffic["cycle"]
    lo, hi = traffic["prompt_tokens"]
    sizes = np.rint(quantiles("uniform", lo, hi, B)).astype(int)
    budgets = np.rint(quantiles("uniform", *traffic["budget_steps"], cyc)
                      ).astype(int)
    out = []
    for i in range(count):
        if i % cyc == 0:
            order = r.permutation(budgets)
        lens = r.permutation(sizes)
        out.append({"scripts": [script(int(n), r) for n in lens],
                    "steps": int(order[i % cyc])})
    return out


def requests(traffic: dict, seed: int, seconds: float,
             rate: float) -> List[dict]:
    """The open-loop requests due in [0, seconds): {"due": s, "script",
    "frames", "max_tokens", "voice", "seed"}. n = round(rate * seconds)
    arrivals whose gaps are the exponential quantiles in a new order;
    budgets log-uniform over ``budget_frames`` plus the delay pattern's
    channels - 1 steps; prompt lengths uniform over ``prompt_tokens``; a
    ``voice_share`` of the requests name one of the ``voices`` LoRA voices,
    in turn. The schedule is the same for every seed; the scripts and the
    requests' own seeds are the run seed's."""
    fixed, r = rng(0, 2), rng(seed, 2)
    n = max(1, int(round(rate * seconds)))
    gaps = fixed.permutation(exp_gaps(rate, n))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    frames = fixed.permutation(np.rint(quantiles(
        "loguniform", *traffic["budget_frames"], n)).astype(int))
    lens = fixed.permutation(np.rint(quantiles(
        "uniform", *traffic["prompt_tokens"], n)).astype(int))
    n_voiced = int(round(traffic["voice_share"] * n))
    voiced = fixed.permutation(np.arange(n) < n_voiced)
    out, k = [], 0
    for i in range(n):
        if due[i] >= seconds:
            break
        voice = None
        if voiced[i]:
            voice = f"voice{k % traffic['voices']}"
            k += 1
        out.append({"due": float(due[i]), "script": script(int(lens[i]), r),
                    "frames": int(frames[i]),
                    "max_tokens": int(frames[i]) + traffic["delay_steps"],
                    "voice": voice,
                    "seed": int(r.integers(2 ** 31))})
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile by the nearest-rank rule: the smallest value
    with at least q percent of the values at or below it (+inf counts)."""
    v = sorted(values)
    if not v:
        return math.inf
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1]
