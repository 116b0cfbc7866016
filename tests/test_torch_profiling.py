"""The port's cost table (``utils/profiling.py``, ``cli profile``) on the CPU.

The JAX package's table (``tests/test_profiling.py``) is analytic, parsed
from compiled HLO; the port's is measured with ``torch.profiler``, so the
two are held to the same keys and sums, not to each other's numbers:

- a conv's row carries torch's FLOPs, 2·N·H·W·Cin·Cout·9, and its inputs'
  bytes; the roofline keys follow from the H100 ceilings; only the calls in
  the marked window count (one a row per iteration, not the warm-up's);
- a ``unet_torch`` operator's row counts one call per launch of its kernel
  and its bytes by the kernel's own formula (``kernels/*.py``);
- ``summarize`` adds the rows, ``format_table`` prints them with the total
  and the footer, ``diff_tables`` of a table with itself is all zeros;
- ``cli profile --device cpu --size 32 --batch_size 2`` prints a table for
  each ``--arch``, with and without ``--train``, with K1's and K2a's calls
  per iteration (22/5, one more K1 with the CLIP fusion).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.kernels import instance_norm
from unet_implementations_tpu_torch.models.unet import DEFAULT_FEATURES
from unet_implementations_tpu_torch.utils import profiling

ROW_KEYS = {"name", "port", "calls", "device_us", "flops", "bytes", "t_compute_us",
            "t_memory_us", "t_roofline_us", "bound", "share"}
CPU = torch.device("cpu")


def _table(fn, iters=2, dtype=torch.float32):
    """The cost rows of ``iters`` calls in the marked window (the traced
    warm-up before it is not counted: a call a row per iteration)."""
    prof, _ = profiling._marked_window(fn, iters, CPU, record_shapes=True, with_flops=True)
    return profiling.cost_rows(prof, iters, dtype, CPU)


def test_conv_row_flops_and_bytes():
    n, h, w, cin, cout = 2, 16, 12, 5, 7
    x = torch.randn(n, cin, h, w)
    weight, bias = torch.randn(cout, cin, 3, 3), torch.randn(cout)
    rows, busy_us = _table(lambda: F.conv2d(x, weight, bias, padding=1))
    assert [r["name"] for r in rows] == ["aten::conv2d"]
    row = rows[0]
    assert set(row) == ROW_KEYS
    assert row["calls"] == 1 and not row["port"]
    assert row["flops"] == 2 * n * h * w * cin * cout * 9
    assert row["bytes"] == 4 * (x.numel() + weight.numel() + bias.numel())
    assert row["t_compute_us"] == pytest.approx(row["flops"] / profiling.F32_FLOPS_PER_S * 1e6)
    assert row["t_memory_us"] == pytest.approx(row["bytes"] / profiling.HBM_BYTES_PER_S * 1e6)
    assert row["t_roofline_us"] == max(row["t_compute_us"], row["t_memory_us"])
    assert row["bound"] == ("compute" if row["t_compute_us"] >= row["t_memory_us"]
                            else "memory")
    assert row["share"] == pytest.approx(row["t_roofline_us"] / row["device_us"])
    assert busy_us == pytest.approx(row["device_us"])


def test_port_operator_row():
    x = torch.randn(2, 8, 8, 6, dtype=torch.bfloat16)
    scale, bias = torch.ones(6), torch.zeros(6)
    rows, _ = _table(lambda: instance_norm.fused_instance_norm(x, scale, bias),
                     dtype=torch.bfloat16)
    row = next(r for r in rows if r["name"] == "unet_torch::in_lrelu_fwd")
    assert row["port"] and row["calls"] == 1 and row["flops"] == 0
    assert row["bytes"] == instance_norm.forward_bytes(x.shape, 2) == 2 * x.numel() * 2


def test_busy_is_the_union_of_intervals():
    assert profiling._busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert profiling._busy_us([]) == 0.0


class _Record:
    """A raw profiler event: device records carry their launcher's id."""

    def __init__(self, start_us, end_us, linked=0, device=True, annotation=False):
        self.start, self.end, self.linked, self.device = start_us, end_us, linked, device
        self.annotation = annotation

    def is_user_annotation(self):
        return self.annotation

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.device else torch.autograd.DeviceType.CPU

    def linked_correlation_id(self):
        return self.linked

    def start_ns(self):
        return self.start * 1000

    def end_ns(self):
        return self.end * 1000


def test_device_busy_spans_the_window_launches():
    """From the first to the last record the window's calls launched (ids 7
    and 8): an unlinked record between them counts; a warm-up's before them,
    a host event and a host range drawn on the device's timeline do not."""
    records = [_Record(0, 5, linked=3), _Record(10, 12, linked=7), _Record(12, 13),
               _Record(14, 20, linked=8), _Record(15, 16, linked=8), _Record(11, 30, device=False),
               _Record(10, 20, linked=7, annotation=True)]
    assert profiling.device_busy_us(records, {7, 8}) == 9.0
    assert profiling.device_busy_us(records, {99}) == 0.0


def test_summarize_format_and_diff():
    rows, _ = _table(lambda: F.relu(F.conv2d(torch.randn(1, 3, 8, 8), torch.randn(4, 3, 3, 3))))
    s = profiling.summarize(rows)
    assert s["n_ops"] == len(rows) >= 2
    assert s["device_ms"] == pytest.approx(sum(r["device_us"] for r in rows) / 1e3)
    assert s["bytes"] == sum(r["bytes"] for r in rows)
    text = profiling.format_table(rows, top=1, meta={
        "what": "probe", "device": "the CPU", "iters": 2, "busy_us": 1.0, "wall_us": 2.0})
    lines = text.splitlines()
    assert lines[0].split()[:2] == ["device_us", "roofline_us"]
    assert len(lines) == 1 + 1 + 3 and lines[2].startswith(f"TOTAL {len(rows)} ops")
    assert "probe on the CPU" in lines[3] and "ATen rows count" in lines[4]
    diff = profiling.diff_tables(rows, rows)
    assert len(diff) == len(rows)
    assert all(r["delta_us"] == 0 and r["a_us"] == r["b_us"] and r["a_n"] == r["b_n"]
               for r in diff)
    assert profiling.format_diff(diff).splitlines()[-1].endswith("delta=+0.000 ms")


def _k1_bytes(size, batch, itemsize, clip):
    """K1's inputs and outputs over a forward of the 6-stage model: two norms
    a stage and a decoder, and the CLIP fusion's at the bottleneck."""
    sides = [(size >> level, c) for level, c in enumerate(DEFAULT_FEATURES)]
    shapes = [(batch, s, s, c) for s, c in sides for _ in range(2)]
    shapes += [(batch, s, s, c) for s, c in sides[:-1] for _ in range(2)]
    shapes += [(batch, *sides[-1][:1] * 2, DEFAULT_FEATURES[-1])] if clip else []
    return len(shapes), sum(instance_norm.forward_bytes(s, itemsize) for s in shapes)


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
@pytest.mark.parametrize("arch", profiling.ARCHES)
def test_cli_profile_on_cpu(arch, train, capsys, monkeypatch):
    monkeypatch.setattr(profiling, "WARMUPS", 1)  # the traced one only: a quicker test
    table = cli.main(["profile", "--arch", arch, "--device", "cpu", "--size", "32",
                      "--batch_size", "2", "--top", "8", *(["--train"] if train else [])])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[:2] == ["device_us", "roofline_us"]
    assert len(out) == 1 + min(8, len(table["rows"])) + 3
    assert f"{arch} {'train step' if train else 'forward'} b2 32² bfloat16" in out[-2]
    rows = {r["name"]: r for r in table["rows"]}
    assert all(set(r) == ROW_KEYS for r in rows.values())
    calls, nbytes = _k1_bytes(32, 2, 2, arch == "clip_unet")
    assert rows["unet_torch::in_lrelu_fwd"]["calls"] == calls
    assert rows["unet_torch::in_lrelu_fwd"]["bytes"] == nbytes
    assert rows["unet_torch::upsample2x"]["calls"] == 5
    assert rows["aten::conv2d"]["flops"] > 0
    assert ("aten::convolution_backward" in rows) == train
    assert table["busy_us"] == pytest.approx(sum(r["device_us"] for r in rows.values()))
    assert math.isfinite(table["wall_us"]) and table["iters"] == 3
