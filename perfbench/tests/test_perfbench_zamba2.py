"""The ``zamba2-7b.train`` cell's yardstick against the port as it
stands: the family's model-FLOP weights against a count of the port's
parameter tree with each shared block counted at every call, the frozen
flash work at the cell's head_dim-224 hop against the port's ``work``,
the cell as data; and a run of the cell on the card."""
import json
from dataclasses import asdict

import pytest
import torch

from perfbench.families import zamba2 as family
from perfbench.lib import bench, flops
from perfbench.lib.tree import leaves
from perfbench.work import flash_carry, flash_carry_bwd

CELL = "zamba2-7b.train"
BF16, F32 = torch.bfloat16, torch.float32


def test_body_weights_count_each_call():
    """Every weight of two or more dimensions below the embedding, a
    shared block's at each of its calls (block 0 at layers 6 and 17,
    block 1 at 11)."""
    from repro_torch.train.step import params_shapes
    cell = bench.load_cell(CELL)
    model = cell.model_config()
    tree = params_shapes(model, device="cpu")
    uses = [0] * model.num_mem_blocks
    calls = [i for i in model.hybrid_layer_ids if i < model.num_layers]
    for c in range(len(calls)):
        uses[c % model.num_mem_blocks] += 1
    assert calls == [6, 11, 17] and uses == [2, 1]
    total = 0
    for path, t in leaves(tree):
        if t.dim() < 2 or path[0] == "embed":
            continue
        total += t.numel() * (uses[int(path[1])] if path[0] == "shared"
                              else 1)
    assert flops.body_weights(cell.config) == total
    assert family.shared_call(cell.config["model"]) * 3 + \
        18 * family.mamba2_layer(cell.config["model"]) == total


def test_flash_work_at_the_cells_hop():
    from repro_torch.kernels.flash_attention import kernel as fk
    cell = bench.load_cell(CELL)
    tr = cell.traffic
    s = flash_carry.hop_shape(cell.config["model"], tr["batch"], tr["seq"],
                              cell.n_pe)
    assert (s["rows"], s["sq"], s["h"], s["kvh"], s["d"]) == \
        (32, 512, 32, 32, 224)
    m = lambda *shape, dt=BF16: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    q = m(s["rows"], s["sq"], s["h"], s["d"])
    k = m(s["rows"], s["sq"], s["kvh"], s["d"])
    st = (m(s["rows"], s["h"], s["sq"], dt=F32),
          m(s["rows"], s["h"], s["sq"], dt=F32),
          m(s["rows"], s["h"], s["sq"], s["d"], dt=F32))
    for hop in range(cell.n_pe):
        pairs = flash_carry.live_pairs(cell.n_pe, tr["batch"], s["sq"], hop)
        assert flash_carry.work(**s, pairs=pairs) == \
            fk.work(q, k, *st, pairs=pairs)[:2]
        assert flash_carry_bwd.work(**s, pairs=pairs) == \
            fk.backward_work(q, k, st[0], st[2], pairs=pairs)[:2]


def test_the_cell_loads():
    cell = bench.load_cell(CELL)
    assert cell.chips == 1 and cell.n_pe == 4
    cfg = cell.model_config()
    assert cfg.family == "zamba2" and cfg.resolved_head_dim == 224
    assert cfg.attn_scale_frac == 0.5
    names = {m["name"] for m in cell.per_layer}
    assert {"shared_block_ms.train", "flash_carry_roofline",
            "flash_carry_bwd_roofline", "mfu.train"} <= names
    assert [m["name"] for m in cell.end_to_end] == ["train_tokens_per_s",
                                                    "setup_s"]
    # the catalog's keys as published, but the layers kept
    c = cell.config
    assert c["num_hidden_layers"] == cfg.num_layers == 18
    assert c["attention_head_dim"] == cfg.head_dim
    assert c["hybrid_layer_ids"] == list(cfg.hybrid_layer_ids)
    assert c["mamba_ngroups"] == cfg.ssm_ngroups
    assert 2 * c["hidden_size"] == c["attention_hidden_size"]
    assert asdict(cfg)["adapter_rank"] == c["adapter_rank"]


@pytest.mark.cuda
def test_the_cell_runs_on_the_card(card):
    """In a process of its own, after this process has given back the card
    memory it caches (the cell's peak is 54 GB of the 80)."""
    import gc

    from test_perfbench_harness import KEYS, ROOT, _command
    gc.collect()
    torch.cuda.empty_cache()
    got = _command(["--workload", CELL, "--seed", str(2**31 + 77),
                    "--seconds", "5", "--trace", "0"], ROOT)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS and line["correct"] is True, line["checks"]


def test_the_program_is_correct_and_the_control_is_not():
    """At SMOKE widths with the program in fp32 (``small_cell``): the run
    is correct by the cell's limits, the control (fp8 weight products) is
    not."""
    import time

    from perfbench.lib import check, drive
    from small import small_cell
    cell = small_cell(CELL, "float32")
    res = drive.run(cell, 2**31 + 5, 0.2, False, torch.device("cpu"),
                    time.perf_counter())
    assert res["correct"], res["checks"]
    ok, checks = check.judge(res["_kind"].control(), cell.limits["limits"])
    assert not ok, checks
