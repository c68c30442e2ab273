"""The port's communication accounting (``parallel/comm_analysis.py``)
against the JAX module: the TP decode cost model and its table equal
JAX's numbers and text when given JAX's constants (read from the JAX
module by name), the inventory summary and its text equal JAX's on the
same op list, the defaults hold no TPU figure; and the inventory of a
profiled two-rank tensor-parallel decode (spawned gloo ranks,
``tests/torch_mesh_ref.py``): one collective a step for each the mesh
counted, each with a payload, and the prefill's outside the steps."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_mesh_ref as R  # noqa: E402
from moss_ttsd_tpu.core.config import LMConfig as JLMConfig  # noqa: E402
from moss_ttsd_tpu.parallel import comm_analysis as jca  # noqa: E402
from moss_ttsd_tpu.pipeline.prompt import left_pad_batch  # noqa: E402
from moss_ttsd_torch.core.config import LMConfig  # noqa: E402
from moss_ttsd_torch.parallel import comm_analysis as ca  # noqa: E402
from moss_ttsd_torch.utils.convert_jax import lm_state_from_jax  # noqa: E402
from tests.test_comm_analysis import SYNTHETIC_HLO  # noqa: E402
from tests.test_decode import make_prompt  # noqa: E402
from tests.test_torch_lm import jax_tiny  # noqa: E402


def _jax_constants():
    """JAX's hardware and step-time constants, by name."""
    sig = inspect.signature(jca.tp_decode_cost_model).parameters
    hw = ca.Hardware(name="v5e", hbm_gbps=jca.HBM_GBPS,
                     link_gbps=jca.ICI_RING_GBPS,
                     collective_us=jca.ICI_LATENCY_US)
    return hw, {k: sig[k].default for k in ("single_chip_step_us",
                                            "weight_bound_us")}


@pytest.mark.parametrize("batch,restricted", [(8, False), (2, False),
                                              (8, True)])
def test_tp_cost_model_matches_jax(batch, restricted):
    hw, steps = _jax_constants()
    want = jca.tp_decode_cost_model(JLMConfig(), batch,
                                    restricted_head=restricted)
    got = ca.tp_decode_cost_model(LMConfig(), batch, **steps,
                                  restricted_head=restricted, hardware=hw)
    assert [tuple(c) for c in got] == [tuple(c) for c in want]
    assert ca.format_tp_cost_table(got, batch, restricted, hardware=hw) == \
        jca.format_tp_cost_table(want, batch, restricted)


def test_defaults_hold_no_tpu_figure():
    """The step times have no default; the default hardware is the
    card's, named in the table, with none of JAX's v5e figures."""
    sig = inspect.signature(ca.tp_decode_cost_model).parameters
    for k in ("single_chip_step_us", "weight_bound_us"):
        assert sig[k].default is inspect.Parameter.empty
    hw = ca.H100_SXM
    assert hw.name == "H100 SXM"
    assert (hw.hbm_gbps, hw.link_gbps) == (3350.0, 450.0)
    assert not {hw.hbm_gbps, hw.link_gbps, hw.collective_us} & {
        jca.HBM_GBPS, jca.ICI_RING_GBPS, jca.ICI_LATENCY_US}
    costs = ca.tp_decode_cost_model(LMConfig(), 2, single_chip_step_us=30e3,
                                    weight_bound_us=ca.weight_bound_us(
                                        3_400_000_000))
    assert ca.format_tp_cost_table(costs, 2).startswith(
        "[comm] H100 SXM TP decode cost model @B2")
    assert ca.weight_bound_us(3_350_000_000) == pytest.approx(1000.0)


def test_summary_and_format_match_jax():
    jops = jca.collective_inventory(SYNTHETIC_HLO)
    ops = [ca.CollectiveOp(*op) for op in jops]
    assert ca.summarize_inventory(ops) == jca.summarize_inventory(jops)
    assert ca.format_inventory("synthetic", ops) == \
        jca.format_inventory("synthetic", jops)
    assert ca.format_inventory("x", []) == jca.format_inventory("x", [])


def test_inventory_of_a_tp_decode_step(tmp_path):
    """Two decode steps of a (1, 2) tensor-parallel engine, profiled:
    per step as many collectives as the mesh counted (2 a layer, the text
    embedding, the head's gather, the token broadcast), each with a
    payload and a host time; the prefill's collectives fall outside."""
    jcfg, params = jax_tiny(5)
    cfg = LMConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(2)
    prompts = [make_prompt(jcfg, rng, 5 + i, 3) for i in range(2)]
    batch, mask = left_pad_batch(prompts, jcfg.pad_token_id,
                                 jcfg.speech_pad_token)
    inp = str(tmp_path / "inputs.pt")
    torch.save({"cfg": cfg.to_dict(), "state": lm_state_from_jax(params, cfg),
                "batch": batch, "mask": mask}, inp)
    for got in R.spawn(2, R.tp_inventory, str(tmp_path / "w2"), inp):
        ops = [op for op, _ in got["events"]]
        s = ca.summarize_inventory(ops)
        per_step = sum(n for n, _ in s["per_step"].values()) / 2
        assert per_step == got["counted_per_step"] == \
            2 * cfg.num_hidden_layers + 3
        assert s["per_step"]["broadcast"][0] == 2
        assert set(s["per_step"]) == {"all_reduce", "broadcast"}
        assert s["per_call"], "the prefill's collectives"
        assert all(op.bytes > 0 for op in ops)
        assert all(op.computation == ("decode_step" if op.per_step else "")
                   for op in ops)
        assert all(us >= 0 for _, us in got["events"])
        n_ar = 2 * (2 * cfg.num_hidden_layers + 2)
        assert f"per_step: {n_ar}x all_reduce" in ca.format_inventory("tp",
                                                                      ops)
