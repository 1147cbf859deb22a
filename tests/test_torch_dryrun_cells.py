"""``repro_torch.launch.dryrun.run_cell`` on production cells of the
multi-pod dry run, on the CPU: ``ok`` with the reference's record keys
(the op count's bytes as ``bytes_op_model``, the wall as
``count_wall_s``) on a few cells, llama3-405b's ``train_4k`` among them
(Adafactor under ZeRO; ~2 min on the CPU: 8 microbatches of 126 layers,
forward, remat and backward, counted op by op); ``skip`` with the
reference's reason for a pure-attention arch's ``long_500k``; an error
recorded, not raised; and no process group left behind.  Every record
counts 0 kernel launches.
"""

import pytest
import torch.distributed as dist

from repro.models.config import SHAPES, shape_applicable
from repro_torch.configs import get_config
from repro_torch.launch.analysis import PEAK_FLOPS_BF16
from repro_torch.launch.dryrun import run_cell

REFERENCE_KEYS = {"status", "policy", "kind", "flops", "bytes_accessed",
                  "collective_bytes", "collectives", "compute_s", "memory_s",
                  "collective_s", "dominant", "step_time_s",
                  "per_device_mem_bytes", "params", "active_params"}


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("qwen2-7b", "decode_32k", False),
    ("zamba2-1.2b", "decode_32k", True),
    ("xlstm-1.3b", "long_500k", False),
    ("granite-moe-3b-a800m", "decode_32k", False),
    ("llama3-405b", "train_4k", True),     # Adafactor under ZeRO
])
def test_run_cell_ok_on_production_cells(arch, shape, multi_pod):
    rec = run_cell(arch, shape, multi_pod=multi_pod)
    assert rec["status"] == "ok", rec.get("traceback")
    assert REFERENCE_KEYS | {"bytes_op_model", "count_wall_s"} <= set(rec)
    # counted on fake CPU tensors: every wrapper took its plain version
    assert set(rec["kernel_launches"].values()) == {0}
    assert set(rec["per_device_mem_bytes"]) == {"argument", "output",
                                                "temp", "alias"}
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["step_time_s"] == max(rec["compute_s"], rec["memory_s"],
                                     rec["collective_s"])
    assert rec["compute_s"] == rec["flops"] / PEAK_FLOPS_BF16
    if SHAPES[shape].kind == "train":
        assert rec["collectives"]["count"]["all_reduce"] > 0
        # the parameters and the optimizer state are updated in place
        assert rec["per_device_mem_bytes"]["alias"] > 0
    assert not dist.is_initialized()


def test_run_cell_skips_long_500k_of_pure_attention():
    rec = run_cell("qwen2-7b", "long_500k")
    ok, why = shape_applicable(get_config("qwen2-7b"), "long_500k")
    assert rec == {"arch": "qwen2-7b", "shape": "long_500k", "mesh": "16x16",
                   "status": "skip", "reason": why}
    assert not ok


def test_run_cell_records_an_error_and_leaves_no_group():
    rec = run_cell("qwen2-7b", "decode_32k",
                   cfg_overrides={"family": "none"})    # no such family
    assert rec["status"] == "error" and rec["error"]
    assert not dist.is_initialized()
