"""The port's profiling module and ``reconstruct --trace/--metrics`` against
the JAX package's.

``FusionMetrics`` keeps the JAX report keys and values; only the roofline
fraction differs by design: it divides by the peak of the card the report
names (``torch.cuda.get_device_name``), and is ``None`` for a card the
table does not know, where the JAX package takes the v5e peak.
"""

import json

import pytest

from cudadepthmapintegration_torch.cli import reconstruct as t_reconstruct
from cudadepthmapintegration_torch.utils import FusionMetrics, device_memory_stats, trace
from cudadepthmapintegration_torch.utils import profiling
from cudadepthmapintegration_tpu.cli import reconstruct as j_reconstruct
from cudadepthmapintegration_tpu.io import write_depth_map_vti, write_krtd
from cudadepthmapintegration_tpu.testing import sphere_scene
from cudadepthmapintegration_tpu.utils import FusionMetrics as JaxMetrics

H100 = "NVIDIA H100 80GB HBM3"


def filled(cls, **kw):
    """The inputs of tests/test_utils.py::test_fusion_metrics_report."""
    m = cls(**kw)
    m.seconds = 2.0
    return m.add_fusion(num_cells=1000, num_views=50, passes=2)


@pytest.mark.parametrize("chip", [H100, "NVIDIA A100-SXM4-80GB", ""])
def test_report_has_the_jax_keys_and_values(chip):
    got = filled(FusionMetrics, chip=chip).report()
    exp = filled(JaxMetrics, chip="v5e").report()
    assert list(got) == list(exp)
    for key in exp:
        if key != "hbm_roofline_fraction":
            assert got[key] == exp[key], key
    json.loads(filled(FusionMetrics, chip=chip).json())


def test_fraction_is_bytes_per_second_over_the_card_peak():
    m = filled(FusionMetrics, chip=H100)
    assert profiling.HBM_PEAK[H100] == 3.35e12
    assert m.hbm_roofline_fraction == (2 * 2 * 4 * 1000 / 2.0) / 3.35e12


@pytest.mark.parametrize("chip", ["NVIDIA A100-SXM4-80GB", "v5e", ""])
def test_fraction_is_none_for_an_unknown_card(chip):
    m = filled(FusionMetrics, chip=chip)
    assert m.hbm_roofline_fraction is None
    assert json.loads(m.json())["hbm_roofline_fraction"] is None


def test_start_stop_and_zero_seconds():
    m = FusionMetrics(chip=H100).start().stop()
    assert m.seconds >= 0
    assert m.voxel_updates_per_sec == 0.0
    assert FusionMetrics(chip=H100).hbm_roofline_fraction == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    d = tmp_path / "trace"
    with trace(str(d)):
        torch.ones((8, 8)).sum()
    files = list(d.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with trace(str(tmp_path)):
            raise KeyError("boom")
    assert len(list(tmp_path.iterdir())) == 1


def test_device_memory_stats_on_the_cpu():
    assert device_memory_stats("cpu") == {}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = tmp_path_factory.mktemp("scene")
    views = sphere_scene(n_views=6, width=48, height=36, focal=45.0)
    for i, v in enumerate(views):
        write_depth_map_vti(str(folder / f"f{i}.vti"), v.depth, v.color, v.best_cost)
        write_krtd(str(folder / f"f{i}.krtd"), v.camera)
    (folder / "vtiList.txt").write_text("".join(f"f{i}.vti\n" for i in range(6)))
    (folder / "kList.txt").write_text("".join(f"f{i}.krtd\n" for i in range(6)))
    return folder


def cli_args(folder, out):
    return ["--gridDims", "14", "12", "10", "--gridOrigin", "-1.6", "-1.6", "-1.6",
            "--gridEnd", "1.6", "1.6", "1.6", "--rayThick", "0.1", "--rayDelta", "0.3",
            "--threshBestCost", "0.5", "--dataFolder", str(folder),
            "--outputMeshFilename", str(out / "mesh.vtp"),
            "--outputGridFilename", str(out / "grid.vts"), "--mhaPath", "",
            "--metrics", str(out / "metrics.json")]


def test_reconstruct_trace_and_metrics(dataset, tmp_path):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_out.mkdir(), port_out.mkdir()
    assert j_reconstruct.main(cli_args(dataset, jax_out)) == 0
    args = cli_args(dataset, port_out) + ["--device", "cpu", "--trace", str(port_out / "trace"),
                                          "--streamBatch", "4"]
    assert t_reconstruct.main(args) == 0
    exp = json.loads((jax_out / "metrics.json").read_text())
    got = json.loads((port_out / "metrics.json").read_text())
    assert list(got) == list(exp)
    assert got["voxels"] == exp["voxels"] == 13 * 11 * 9
    assert got["views"] == exp["views"] == 6
    assert got["seconds"] > 0 and got["voxel_updates_per_sec"] > 0
    assert got["hbm_roofline_fraction"] is None  # --device cpu names no card
    (trace_file,) = (port_out / "trace").iterdir()
    events = json.loads(trace_file.read_text())["traceEvents"]
    assert events and (port_out / "mesh.vtp").exists()


@pytest.mark.parametrize("stream_batch, sweeps", [("4", 2), ("32", 1)])
def test_metrics_count_one_sweep_a_launch(dataset, tmp_path, monkeypatch, stream_batch, sweeps):
    # 6 views in stream batches of 4: two launches, two volume sweeps.
    recorded = []
    add_fusion = FusionMetrics.add_fusion

    def recording(self, *a, **k):
        out = add_fusion(self, *a, **k)
        recorded.append(self.bytes_volume_traffic)
        return out

    monkeypatch.setattr(FusionMetrics, "add_fusion", recording)
    assert t_reconstruct.main(cli_args(dataset, tmp_path)
                              + ["--device", "cpu", "--streamBatch", stream_batch]) == 0
    assert recorded == [sweeps * 2 * 4 * 13 * 11 * 9]
