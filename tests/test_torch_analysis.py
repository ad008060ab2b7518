"""The port's cost model and roofline (``repro_torch.analysis``) against
``repro``'s.

``step_costs``, ``forward_flops`` and ``model_flops_for`` are host
arithmetic and must equal ``repro``'s exactly for every assigned arch x
input shape x production mesh x schedule.  The roofline's terms follow
the H100 datasheet's constants.  The collective counter runs in a
subprocess as one rank of a fake process group (it may not share this
process's default group) and must give, for collectives whose results
are those of ``tests/test_analysis.py``'s ``SAMPLE_HLO`` lines, the
bytes ``repro``'s HLO parser gives for each line.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
from test_analysis import SAMPLE_HLO

from repro.analysis import costmodel as RCM
from repro.analysis.roofline import collective_bytes
from repro.analysis.roofline import model_flops_for as r_model_flops_for
from repro.configs import ARCHS as R_ARCHS
from repro.configs import ASSIGNED
from repro.configs import INPUT_SHAPES as R_SHAPES
from repro_torch.analysis import costmodel as CM
from repro_torch.analysis import roofline as RL
from repro_torch.configs import ARCHS, INPUT_SHAPES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name -> (chips, model, data, pods)
MESHES = {"pod16x16": (256, 16, 16, 1), "2pod16x16": (512, 16, 16, 2)}
FSDP = {"llama4-maverick-400b-a17b", "llama4-scout-17b-a16e",
        "internvl2-26b"}


@pytest.mark.parametrize("schedule", ["tolfl_ring", "tolfl_psum"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_costmodel_equals_repro(arch, shape, mesh, schedule):
    chips, model, data, pods = MESHES[mesh]
    kw = dict(model_shards=model, data_shards=data, schedule=schedule,
              num_clusters=4, pods=pods, long_ctx=shape == "long_500k",
              fsdp=arch in FSDP)
    got = CM.step_costs(ARCHS[arch], INPUT_SHAPES[shape], chips, **kw)
    want = RCM.step_costs(R_ARCHS[arch], R_SHAPES[shape], chips, **kw)
    assert (got.flops, got.hbm_bytes, got.coll_bytes) == \
        (want.flops, want.hbm_bytes, want.coll_bytes)
    assert got.detail == want.detail
    s = INPUT_SHAPES[shape]
    for mode in ("train", "prefill", "decode"):
        assert CM.forward_flops(ARCHS[arch], s.global_batch, s.seq_len,
                                mode, shape == "long_500k") == \
            RCM.forward_flops(R_ARCHS[arch], s.global_batch, s.seq_len, mode,
                              shape == "long_500k")
    assert RL.model_flops_for(ARCHS[arch], s, s.mode) == \
        r_model_flops_for(R_ARCHS[arch], R_SHAPES[shape], s.mode)
    assert ARCHS[arch].active_param_count() == \
        R_ARCHS[arch].active_param_count()


def test_perf_knobs_equal_repro():
    cfg, shape = "qwen3-8b", "train_4k"
    kw = dict(model_shards=16, data_shards=16, schedule="tolfl_ring",
              grad_sync_dtype="bfloat16", microbatches=4,
              param_cast_dtype="bfloat16", fsdp=True)
    got = CM.step_costs(ARCHS[cfg], INPUT_SHAPES[shape], 256, **kw)
    want = RCM.step_costs(R_ARCHS[cfg], R_SHAPES[shape], 256, **kw)
    assert (got.flops, got.hbm_bytes, got.coll_bytes, got.detail) == \
        (want.flops, want.hbm_bytes, want.coll_bytes, want.detail)


def test_roofline_terms_follow_the_h100_datasheet():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    r = RL.Roofline(arch="a", shape="s", mesh="m", chips=256,
                    flops_per_chip=RL.PEAK_FLOPS,       # 1 s of compute
                    bytes_per_chip=RL.HBM_BW / 2,       # 0.5 s of memory
                    coll_bytes_per_chip=RL.LINK_BW / 4,  # 0.25 s
                    coll_breakdown={}, model_flops=RL.PEAK_FLOPS * 128)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.useful_flops_ratio == pytest.approx(0.5)
    d = r.to_dict()
    assert d["bottleneck"] == "compute" and d["chips"] == 256
    t = RL.build_roofline("a", "s", "m", 256, 2 * RL.PEAK_FLOPS * 256,
                          {"all-reduce": 10, "all-gather": 5}, 1.0)
    assert t.flops_per_chip == 2 * RL.PEAK_FLOPS
    assert t.coll_bytes_per_chip == 15.0
    assert "bottleneck" in RL.format_table([r, t])


COUNTER_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.roofline import CollectiveCounter
    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    m = "meta"
    out = {}
    with CollectiveCounter() as c:
        dist.all_reduce(torch.empty(16, 128, device=m))
    out["all_reduce"] = c.bytes
    with CollectiveCounter() as c:
        dist.all_gather_into_tensor(
            torch.empty(8, 64, dtype=torch.bfloat16, device=m),
            torch.empty(2, 64, dtype=torch.bfloat16, device=m))
    out["all_gather"] = c.bytes
    with CollectiveCounter() as c:
        dist.reduce_scatter_tensor(torch.empty(100, device=m),
                                   torch.empty(400, device=m))
    out["reduce_scatter"] = c.bytes
    with CollectiveCounter() as c:
        dist.send(torch.empty(32, device=m), dst=2)
        dist.recv(torch.empty(32, device=m), src=2)
    out["p2p"] = c.bytes
    # DTensor's own collectives (a row-sharded product's pending sum,
    # reduced inside the next op), each counted once at local bytes,
    # while the flop counter inside sees the global product
    x = DTensor.from_local(torch.empty(2, 4096, 4096, device=m), mesh,
                           [Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(4096, 4096, device=m), mesh,
                           [Replicate()], run_check=False)
    p = DTensor.from_local(torch.empty(2, 4096, 4096, device=m), mesh,
                           [Partial()], run_check=False)
    fc = FlopCounterMode(display=False)
    with CollectiveCounter() as c, fc:
        torch.relu(p) @ w
    out["dtensor"] = c.bytes
    out["dtensor_calls"] = c.calls
    out["flops"] = fc.get_total_flops()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def counted():
    r = subprocess.run([sys.executable, "-c", COUNTER_SCRIPT],
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _line(kind_and_shape):
    """repro's bytes for the one SAMPLE_HLO line holding the text."""
    line = next(l for l in SAMPLE_HLO.splitlines() if kind_and_shape in l)
    return collective_bytes(line)


@pytest.mark.parametrize("case,line,kind", [
    ("all_reduce", "f32[16,128]{1,0} all-reduce", "all-reduce"),
    ("all_gather", "bf16[8,64]{1,0} all-gather", "all-gather"),
    ("reduce_scatter", "f32[100]{0} reduce-scatter", "reduce-scatter")])
def test_collective_counter_equals_repro_hlo_bytes(counted, case, line,
                                                   kind):
    want = _line(line)
    assert want[kind] > 0
    assert counted[case] == want


def test_collective_counter_sees_p2p_and_dtensor_once(counted):
    assert counted["p2p"]["collective-permute"] == 2 * 32 * 4
    # the Partial's all-reduce at its local bytes, not twice (its
    # _wrap_tensor_autograd carries the same bytes)
    assert counted["dtensor"]["all-reduce"] == 2 * 4096 * 4096 * 4
    assert counted["dtensor_calls"]["all-reduce"] == 1
    assert sum(counted["dtensor"].values()) == 2 * 4096 * 4096 * 4
    assert counted["flops"] == 2 * 2 * 4096 * 4096 * 4096
