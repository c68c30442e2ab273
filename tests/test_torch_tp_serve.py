"""Tensor-parallel serving of the port on the CPU, over spawned gloo ranks
(``tests/torch_mesh_ref.py``): the continuous pool under (1, 2) and (2, 1)
with a LoRA voice gives the JAX pool's greedy tokens; ``serve.server
main --mesh 1x2`` with the window and the continuous scheduler answers
as the unsharded server does, the follower replaying the lead's calls
and leaving with it; the inference CLI under ``--mesh 1x2`` writes the
unsharded CLI's wavs (rank 0 alone writes) and runs under 2x1; a
follower that fails stops the server (exit 1) instead of hanging it.
One group serves the pool, the server and the CLI cases (a module-scoped
fixture); the failing follower needs a group of its own."""
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_mesh_ref as R  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import lm_state_from_jax  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from tests.test_torch_continuous import (_schedule, jpool,  # noqa: E402
                                         rand_adapter)
from tests.test_torch_lm import jax_tiny  # noqa: E402

POOL_CASES = [("tp", (1, 2), {}), ("dp", (2, 1), {}),
              ("tp_kv8", (1, 2), {"kv_quant": "int8"})]
REQUESTS = [{"input": R.SERVE_TEXT, "seed": 1, "max_tokens": 16},
            {"input": R.SERVE_TEXT, "seed": 2, "max_tokens": 12,
             "stream": True}]
SCHEDULERS = ("window", "continuous")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, params = jax_tiny(7)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    adapter = rand_adapter(cfg, 1, rank=4)
    sched = _schedule(jcfg, 21, adapters=(None, "v1", None))
    tmp = tmp_path_factory.mktemp("tp_serve")
    inp = str(tmp / "inputs.pt")
    torch.save({"cfg": cfg.to_dict(), "state": lm_state_from_jax(params, cfg)},
               inp)
    return jcfg, params, adapter, sched, tmp, inp


@pytest.fixture(scope="module")
def ranks(setup):
    *_, adapter, sched, tmp, inp = setup
    ports = [(s, _free_port(), REQUESTS) for s in SCHEDULERS]
    cli = [("1x2", str(tmp / "cli_tp")), ("2x1", str(tmp / "cli_dp"))]
    res = R.spawn(2, R.serve_cases, str(tmp / "w2"), inp,
                  (POOL_CASES, sched, adapter), ports, cli, timeout=240)
    return res, dict(cli)


@pytest.mark.parametrize("name", [c[0] for c in POOL_CASES])
def test_pool_matches_jax_pool(ranks, setup, name):
    """Staggered joins, the middle row on voice v1: every rank's pool rows
    give the JAX pool's greedy tokens and steps (the int8 KV cache
    against JAX's int8 KV pool)."""
    jcfg, params, adapter, sched, *_ = setup
    kw = next(c for c in POOL_CASES if c[0] == name)[2]
    jcb = jpool(jcfg, params, **kw)
    jcb.register_adapter("v1", adapter, alpha=8.0)
    ref = R.drive_pool(jcb, sched)
    for r in ranks[0]:
        got = r["pool"][name]
        assert [s for s, _ in got] == [s for s, _ in ref]
        for (_, g), (_, e) in zip(got, ref):
            np.testing.assert_array_equal(g, e)


@pytest.fixture(scope="module")
def unsharded_replies():
    """The same requests to the unsharded tiny server, per scheduler."""
    from moss_ttsd_torch.cli.inference import build_tiny_pipeline
    from moss_ttsd_torch.serve.server import SpeechServer
    out = {}
    for sched in SCHEDULERS:
        server = SpeechServer(build_tiny_pipeline(device="cpu"),
                              host="127.0.0.1", port=0, scheduler=sched,
                              pool_base=192, pool_max_steps=32,
                              segment_steps=8)
        server.start()
        try:
            out[sched] = [R._post(server.port, p) for p in REQUESTS]
        finally:
            server.stop()
    return out


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_mesh_server_answers_as_unsharded(ranks, unsharded_replies, sched):
    """``main --mesh 1x2``: the lead's wav and streamed PCM equal the
    unsharded server's bytes; both ranks' main return 0 (the follower
    when the lead stops it), and the follower replayed the lead's calls."""
    lead, follower = ranks[0]
    got = lead[sched]
    assert got["code"] == 0 and follower[sched]["code"] == 0
    assert [s for s, _ in got["replies"]] == [200, 200]
    for (_, body), (status, ref) in zip(got["replies"],
                                        unsharded_replies[sched]):
        assert status == 200 and len(body) > 44
        assert body == ref
    assert follower[sched]["follower_calls"] >= 2


def test_inference_cli_under_a_mesh(ranks, tmp_path):
    """``--mesh 1x2`` writes the unsharded CLI's wavs (rank 0 alone
    writes them); ``--mesh 2x1`` splits the two items over the data ranks
    and writes both."""
    from moss_ttsd_torch.cli.inference import main
    res, dirs = ranks
    assert all(r["1x2"] == 0 and r["2x1"] == 0 for r in res)
    ref = str(tmp_path / "ref")
    assert main(["--tiny", "--platform", "cpu", "--jsonl",
                 os.path.join(R.ROOT, "examples", "examples_only_text.jsonl"),
                 "--max_new_tokens", "24", "--seed", "3", "--output_dir",
                 ref]) == 0
    names = sorted(os.listdir(ref))
    assert names and sorted(os.listdir(dirs["1x2"])) == names
    for n in names:
        with open(os.path.join(ref, n), "rb") as a, \
                open(os.path.join(dirs["1x2"], n), "rb") as b:
            assert a.read() == b.read(), n
    assert sorted(os.listdir(dirs["2x1"]))


def test_failing_follower_stops_the_server(setup):
    """A follower whose generate raises exits 1; the lead's request gets
    an error reply and its main returns 1 instead of hanging."""
    tmp = setup[4]
    lead, follower = R.spawn(2, R.failing_follower, str(tmp / "fail"),
                             _free_port(), codes=[0, 1], timeout=150)
    assert follower is None
    assert lead["code"] == 1
    (status, body), = lead["replies"]
    assert status == 500
