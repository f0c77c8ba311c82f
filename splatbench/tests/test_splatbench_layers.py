"""Every kernel of the port is in exactly one layer table, and the tables
are the layers BENCHMARK.json names."""

import json
import re

from splatbench import trace
from splatbench.tests import fixture

KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernels():
    out = []
    for path in sorted((fixture.REPO / "websplat_tpu_torch" / "csrc").glob("*.cu")):
        out += KERNEL.findall(path.read_text())
    return out


def test_every_kernel_is_in_exactly_one_table():
    layers = trace.load_layers(fixture.DATA / "layers")
    names = kernels()
    assert len(names) >= 14
    for k in names:
        for shown in (f"void ws::{k}<false, true>(float const*, int)", f"void {k}(int*)",
                      f"_Z{len(k)}{k}PKfi"):
            assert len(trace.layers_of(shown, layers)) == 1, (k, shown)


def test_library_kernels_are_unmatched():
    layers = trace.load_layers(fixture.DATA / "layers")
    for name in ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<int> >(int)",
                 "Memcpy DtoD (Device -> Device)", "void cub::DeviceRadixSortOnesweepKernel()"):
        assert trace.layers_of(name, layers) == []


def test_tables_name_the_benchmark_layers():
    spec = json.loads((fixture.REPO / "BENCHMARK.json").read_text())
    named = {m["layer"] for m in spec["per_layer"]}
    tables = {ly.name for ly in trace.load_layers(fixture.DATA / "layers")}
    assert tables <= named
