"""Ranks of a ``gloo`` process group for the mesh tests: ``spawn`` starts
one process a rank, each joins the group through ``initialize_multihost``
over a file store, runs a module-level function of this file and saves
what it returns for the test to compare. Imports torch and the port only,
so a spawned process starts without JAX; the tests compute the JAX
references in their own process.

The functions read their inputs from a ``torch.save`` file the test
writes: the LM config (``LMConfig.to_dict``), the full port state dict
(carried from JAX by ``lm_state_from_jax``) and the batch."""
import contextlib
import multiprocessing
import os
import traceback

import numpy as np
import torch

TIMEOUT_S = 150


def spawn(world, fn, tmp, *args, env=None, timeout=TIMEOUT_S, codes=None):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned ranks of a gloo
    group; returns each rank's result, in rank order (None for a rank that
    saved none). A rank that does not exit within ``timeout``, or exits
    with another code than ``codes`` (default all 0), fails the call (the
    others are killed). ``env``: variables each rank sets before it
    runs."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(tmp, exist_ok=True)
    init = "file://" + os.path.join(tmp, f"store_{fn.__name__}")
    outs = [os.path.join(tmp, f"{fn.__name__}_rank{r}.pt")
            for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, outs[r], env) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not any(alive), f"{fn.__name__}: a rank did not exit in time"
    got = [p.exitcode for p in procs]
    assert got == (codes or [0] * world), \
        f"{fn.__name__}: rank exit codes {got}"
    return [torch.load(o, weights_only=False) if os.path.exists(o) else None
            for o in outs]


def _rank_main(fn, rank, world, init, out, env, *args):
    torch.set_num_threads(1)
    os.environ.update(env or {})
    import torch.distributed as dist
    from moss_ttsd_torch.parallel.distributed import initialize_multihost
    initialize_multihost(init, world, rank, device="cpu", timeout_s=120)
    try:
        torch.save(fn(rank, world, *args), out)
    except BaseException:
        traceback.print_exc()
        os._exit(1)
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:                   # noqa: BLE001 — a peer is gone
            pass


def load_inputs(path):
    from moss_ttsd_torch.core.config import LMConfig
    inp = torch.load(path, weights_only=False)
    inp["cfg"] = LMConfig.from_dict(inp["cfg"])
    return inp


def greedy(n=24):
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             SamplingConfig)
    return SamplingConfig(
        channels=[ChannelSamplingConfig(do_sample=False, temperature=None,
                                        top_k=None, top_p=None)
                  for _ in range(8)], max_new_tokens=n)


def sampled(n=24):
    from moss_ttsd_torch.core.config import (ChannelSamplingConfig,
                                             SamplingConfig)
    return SamplingConfig(
        channels=[ChannelSamplingConfig(do_sample=True, temperature=0.8,
                                        top_k=20, top_p=0.9,
                                        repetition_penalty=1.2)
                  for _ in range(8)], max_new_tokens=n)


# -- the engine ------------------------------------------------------------------

def prefill_logits(eng, batch, mask):
    """The full (B, vocab) text and (B, C-1, Vs) speech logits after the
    prefill, every data rank's rows gathered."""
    ids, m, base = eng._bucket_prompt(batch, mask)
    rows = eng._rows(ids.shape[0])
    st = eng.prefill(torch.as_tensor(ids[rows]), torch.as_tensor(m[rows]),
                     base, 16)
    t, s = eng.model.logits_all(st.hidden_last)
    return (eng._gather(t[:, 0]).numpy(), eng._gather(s[:, 0]).numpy())


def engine_cases(rank, world, inp_path, cases):
    """``cases``: (name, (data, model), engine keywords, kind) with kind
    "generate" (tokens, steps, prefill logits), "stream" (the last
    ``generate_stream`` result, chunks of 5) or "draws" (a sampled run's
    step-0 per-channel logits the draws see, every row gathered)."""
    from moss_ttsd_torch.decode import engine as peng
    from moss_ttsd_torch.parallel.mesh import make_mesh
    inp = load_inputs(inp_path)
    cfg, state, batch, mask = (inp["cfg"], inp["state"], inp["batch"],
                               inp["mask"])
    out = {}
    for name, (d, m), kw, kind in cases:
        mesh = make_mesh(d, m, device_type="cpu")
        kw = dict(kw)
        samp = sampled() if kind == "draws" else greedy()
        eng = peng.GenerationEngine(cfg, state, samp, bucket=32,
                                    device="cpu", mesh=mesh, **kw)
        if kind == "generate":
            r = eng.generate(batch, mask, max_new_tokens=12, seed=0)
            t, s = prefill_logits(eng, batch, mask)
            out[name] = {"tokens": r.tokens, "steps": r.steps,
                         "audit": r.audit, "text": t, "speech": s,
                         "collectives": mesh.collectives}
        elif kind == "stream":
            last = None
            for last in eng.generate_stream(batch, mask, max_new_tokens=12,
                                            seed=0, chunk_steps=5):
                pass
            out[name] = {"tokens": last.tokens, "steps": last.steps}
        else:
            with recorded_draws() as seen:
                r = eng.generate(batch, mask, max_new_tokens=4, seed=3)
            C = cfg.channels
            out[name] = {"draw_logits": [eng._gather(x).numpy()
                                         for x in seen[:C]],
                         "tokens": r.tokens}
    return out


@contextlib.contextmanager
def recorded_draws():
    """The per-channel logits every draw of the engine sees, in order."""
    from moss_ttsd_torch.decode import engine as peng
    seen = []
    real = peng.sample_from_channel

    def spy(gen, x, *a, **k):
        seen.append(x.clone())
        return real(gen, x, *a, **k)
    peng.sample_from_channel = spy
    try:
        yield seen
    finally:
        peng.sample_from_channel = real


def file_cases(rank, world, inp_path, cases):
    """``test_torch_mesh.py``'s cases of one group: the engine's and the
    mesh argument's."""
    return {"engine": engine_cases(rank, world, inp_path, cases),
            "parse": parse_refusals(rank, world)}


def parse_refusals(rank, world):
    """``parse_mesh_arg`` over a group of ``world``: the messages of the
    specs that do not fit it, and the shape of one that does."""
    from moss_ttsd_torch.parallel.mesh import parse_mesh_arg
    msgs = {}
    for spec in ("2x2", "1x1", "4x1", "x2", "0x2"):
        try:
            parse_mesh_arg(spec, device_type="cpu")
            msgs[spec] = None
        except ValueError as e:
            msgs[spec] = str(e)
    msgs["fits"] = parse_mesh_arg(f"1x{world}", device_type="cpu").shape
    return msgs


# -- data-parallel finetuning ----------------------------------------------------

LR = 1e-3
TRAIN_STEPS = 3


def train_run(inp_path, lora, K, group=None, rank=0, world=1):
    """``TRAIN_STEPS`` steps of the full (or layerwise LoRA) step at
    accumulation ``K`` on the input file's global batch; under ``group``
    this rank's rows of each micro batch (``shard_train_step`` over a
    (world, 1) mesh). Returns the losses, grad norms and the trained
    tensors, as numpy."""
    import dataclasses
    from moss_ttsd_torch.models.lm import AsteroidLM
    from moss_ttsd_torch.train import lora as plora
    from moss_ttsd_torch.train.step import (init_train_state, make_optimizer,
                                            make_train_step,
                                            shard_train_step)
    inp = load_inputs(inp_path)
    cfg = inp["cfg"]
    model = AsteroidLM(cfg)
    model.load_state_dict(inp["state"])
    opt = make_optimizer(learning_rate=LR, total_steps=10, warmup_ratio=0.0,
                         lr_scheduler_type="constant")
    kw = dict(remat=False, ce_chunks=2, grad_accum_steps=K)
    if lora:
        lcfg = dataclasses.replace(cfg, lora_rank=4, lora_alpha=8.0,
                                   lora_targets=("q_proj", "v_proj",
                                                 "o_proj", "down_proj"))
        model = plora.graft_lora_params(model, lcfg, seed=1)
        state = plora.init_lora_state(model, opt)
        make, step_cfg = plora.make_layerwise_lora_step, lcfg
    else:
        state = init_train_state(cfg, opt, model=model)
        make, step_cfg = make_train_step, cfg
    if group is None:
        step = make(step_cfg, opt, **kw)
    else:
        from moss_ttsd_torch.parallel.mesh import make_mesh
        step = shard_train_step(make, make_mesh(world, 1, device_type="cpu"),
                                step_cfg, opt, **kw)
    batch = {k: torch.as_tensor(v) for k, v in inp["train_batch"].items()}
    B = batch["labels"].shape[0]
    if K > 1:
        batch = {k: v.reshape((K, B // K) + v.shape[1:])
                 for k, v in batch.items()}
    if group is not None:
        n = batch["labels"].shape[1 if K > 1 else 0]
        per = n // world
        rows = slice(rank * per, (rank + 1) * per)
        batch = {k: (v[:, rows] if K > 1 else v[rows])
                 for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": np.array(losses), "grad_norm": np.array(norms),
            "per_channel": m["loss_per_channel"].numpy(),
            "params": {k: v.detach().numpy().copy()
                       for k, v in state.params.items()}}


def dp_train_cases(rank, world, inp_path, cases):
    """``train_run`` of each (name, lora, K) case over the whole group."""
    import torch.distributed as dist
    return {name: train_run(inp_path, lora, K, group=dist.group.WORLD,
                            rank=rank, world=world)
            for name, lora, K in cases}


# -- serving ---------------------------------------------------------------------

POOL_BASE = 24


def drive_pool(cb, schedule, seg=4, rounds=16):
    """Submit (prompt, budget, seed, adapter) requests at the pool steps of
    ``schedule`` [(steps to run first, request), ...], then run segments
    of ``seg`` until all finish; the collected (steps, tokens) in order."""
    slots = []
    for pre, req in schedule:
        if pre:
            cb.run(steps=pre)
        slots.append(cb.submit(req[0], max_new_tokens=req[1], seed=req[2],
                               adapter=req[3]))
    for _ in range(rounds):
        cb.run(steps=seg)
        if len(cb.finished()) == len(slots):
            break
    assert sorted(cb.finished()) == sorted(slots)
    return [(r.steps, r.tokens[0, r.base:]) for r in map(cb.collect, slots)]


def pool_cases(inp_path, cases, schedule, adapter):
    """The fp32 pool (3 slots, base 24, 32 steps) over each (name,
    (data, model), pool keywords) mesh, the voice "v1" registered."""
    from moss_ttsd_torch.decode.continuous import ContinuousBatcher
    from moss_ttsd_torch.parallel.mesh import make_mesh
    inp = load_inputs(inp_path)
    out = {}
    for name, (d, m), kw in cases:
        cb = ContinuousBatcher(inp["cfg"], inp["state"], greedy(), slots=3,
                               base=POOL_BASE, max_steps=32, device="cpu",
                               mesh=make_mesh(d, m, device_type="cpu"), **kw)
        cb.register_adapter("v1", adapter, alpha=8.0)
        out[name] = drive_pool(cb, schedule)
    return out


def _post(port, payload, timeout=120):
    import http.client
    import json
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/audio/speech", json.dumps(payload),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, r.read()


def _wait_up(port, deadline_s=120):
    import http.client
    import time
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/health")
            if conn.getresponse().status == 200:
                return
        except OSError:
            time.sleep(0.2)
    raise TimeoutError("the server did not come up")


SERVE_TEXT = "[S1]Hello there.[S2]Hi, how are you?"


def serve_main(port, scheduler, requests, out, interrupt=True):
    """``serve.server.main --mesh 1x2`` on this group; on rank 0 a client
    thread sends ``requests`` one at a time, keeps the replies in ``out``
    and (``interrupt``) ends the server with SIGINT. Returns main's exit
    code."""
    import signal
    import threading
    import torch.distributed as dist
    from moss_ttsd_torch.serve import server

    def client():
        try:
            _wait_up(port)
            for payload in requests:
                out.append(_post(port, payload))
        finally:
            if interrupt:
                os.kill(os.getpid(), signal.SIGINT)
    if dist.get_rank() == 0:
        threading.Thread(target=client, daemon=True).start()
    return server.main(["--tiny", "--platform", "cpu", "--host",
                        "127.0.0.1", "--port", str(port), "--mesh", "1x2",
                        "--scheduler", scheduler, "--pool_base", "192",
                        "--pool_max_steps", "32", "--segment_steps", "8"])


def serve_cases(rank, world, inp_path, pool_args, ports, cli_args):
    """``test_torch_tp_serve.py``'s cases of one group, in order: the pool
    meshes; the server's main under --mesh 1x2 with each scheduler
    (rank 0's replies, every rank's exit code and mirrored calls); the
    inference CLI under --mesh 1x2 and 2x1. main and the CLI leave the
    group, so the rank joins a new one (a file store beside the first)
    before each."""
    import torch.distributed as dist
    from moss_ttsd_torch.cli import inference
    from moss_ttsd_torch.parallel import mirror
    from moss_ttsd_torch.parallel.distributed import initialize_multihost
    out = {"pool": pool_cases(inp_path, *pool_args)}
    calls = []
    real_follow = mirror.Channel.follow

    def follow(self, engine):
        try:
            return real_follow(self, engine)
        finally:
            calls.append(self.calls)
    mirror.Channel.follow = follow
    store = inp_path + f".store{world}"
    for i, (scheduler, port, requests) in enumerate(ports):
        if not dist.is_initialized():
            initialize_multihost(f"file://{store}_serve{i}", world, rank,
                                 device="cpu", timeout_s=120)
        replies = []
        code = serve_main(port, scheduler, requests, replies)
        out[scheduler] = {"code": code, "replies": replies,
                          "follower_calls": calls[-1] if rank else None}
    for i, (spec, out_dir) in enumerate(cli_args):
        if not dist.is_initialized():
            initialize_multihost(f"file://{store}_cli{i}", world, rank,
                                 device="cpu", timeout_s=120)
        out[spec] = inference.main(
            ["--tiny", "--platform", "cpu", "--mesh", spec, "--jsonl",
             os.path.join(ROOT, "examples", "examples_only_text.jsonl"),
             "--max_new_tokens", "24", "--seed", "3", "--output_dir",
             out_dir])
    return out


def failing_follower(rank, world, port):
    """``serve.server.main --mesh 1x2`` whose follower fails at its first
    generate: the follower exits 1, the request fails, main returns 1."""
    from moss_ttsd_torch.decode.engine import GenerationEngine
    if rank == 1:
        def broken(self, *a, **k):
            raise RuntimeError("follower out of memory (injected)")
        GenerationEngine.generate = broken
    replies = []
    code = serve_main(port, "window", [{"input": SERVE_TEXT, "seed": 1,
                                        "max_tokens": 16}], replies,
                      interrupt=False)
    return {"code": code, "replies": replies}


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
