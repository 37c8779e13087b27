"""The yardstick's counts against hand counts."""

import json

import pytest

from portbench import work
from portbench.registry import Registry


def test_attention_fwd_at_the_kernel_tables_shape():
    # 64 x 12 x 32 x 64 bf16: 4 tensors of 1,572,864 elements (2 bytes)
    # and an 8 KB fp32 mask; 4·B·H·L²·D = 201,326,592 operations
    ops, nbytes = work.attention_fwd(64, 12, 32, 64)
    assert ops == 4 * 64 * 12 * 32 * 32 * 64 == 201_326_592
    assert nbytes == 4 * 1_572_864 * 2 + 4 * 64 * 32 == 12_591_104
    # the kernel table's bound: 0.00376 ms, by bytes
    assert 1e3 * work.least_s(ops, nbytes) == pytest.approx(0.00376,
                                                           abs=5e-6)
    assert nbytes / work.PEAK_BYTES_PER_S > ops / 989e12


def test_bert_forward_flops_by_hand():
    model = {"hidden_size": 768, "intermediate_size": 3072,
             "num_hidden_layers": 12}
    b, l = 64, 64
    per_layer = (2 * b * l * 768 * 768 * 4  # q, k, v, out projections
                 + 2 * b * l * 768 * 3072 * 2  # feed-forward in and out
                 + 2 * 2 * b * l * l * 768)  # QKᵀ and PV
    assert work.bert_forward_flops(model, b, l) == 12 * per_layer
    # both towers over a batch of 64 at 64 tokens: 1.41 TFLOP
    assert 2 * work.bert_forward_flops(model, b, l) == pytest.approx(
        1.41e12, rel=0.01)


def test_flat_scan_and_pq_scan_counts():
    ops, nbytes = work.flat_scan(128, 1_000_000, 768)
    assert ops == 2 * 128 * 1_000_000 * 768 and nbytes == 768_000_000
    ops, nbytes = work.pq_scan(128, 10_000, 96, 256, 320)
    assert ops == 128 * 10_000 * 96
    assert nbytes == (10_000 * 96 + 2 * 128 * 96 * 256 + 4 * 320
                      + 4 * 128 * 10_000)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Registry().spec["workloads"]])
def test_request_work_of_each_cell(cell):
    reg = Registry()
    plan = reg.plan(cell)
    w = plan["route"].request_work(plan["config"], plan["traffic"])
    model, traffic = plan["config"]["model"], plan["traffic"]
    assert w["attn_fwd"]["launches"] == 2 * model["num_hidden_layers"]
    assert w["step_flops"] > 2 * work.bert_forward_flops(
        model, traffic["batch"], traffic["max_query_length"])
    json.dumps(w)
