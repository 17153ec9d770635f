"""The auxiliaries of ROADMAP A.18 that measurement uses
(sfvp_tpu_torch/utils: profiling, diagnostics, metrics) and the CLI's
--devices, against sfvp_tpu's: tests/test_aux.py:246-267 on the port,
tests/test_render.py:150-153's --devices check, the metrics equal to
sfvp_tpu.utils.metrics on the same arrays, StepTimer's EMA equal to
sfvp_tpu's on a patched clock; and --preview-port, not ported, refused.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from sfvp_tpu_torch.cli import main
from sfvp_tpu_torch.utils import metrics, profiling
from sfvp_tpu_torch.utils.diagnostics import check_capabilities, device_report


def test_torch_device_report_and_capabilities():
    rep = device_report()
    assert len(rep) >= 1 and "platform" in rep[0]
    check_capabilities(min_devices=1)
    with pytest.raises(RuntimeError, match="capability check failed"):
        check_capabilities(min_devices=10 ** 6)
    if not torch.cuda.is_available():
        assert rep == [{"id": 0, "platform": "cpu", "device_kind": "cpu"}]
        with pytest.raises(RuntimeError, match="GPU required"):
            check_capabilities(require_gpu=True)


def test_torch_profiling_scopes_and_timer(tmp_path):
    def f(x):
        with profiling.named_scope("sfvp_test_phase"):
            return x * 2

    with profiling.profile_trace(str(tmp_path)) as prof:
        assert float(f(torch.tensor(2.0))) == 4.0
    names = {e.key for e in prof.key_averages()}
    assert "sfvp_test_phase" in names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "sfvp_test_phase"
               for e in trace["traceEvents"])
    timer = profiling.StepTimer()
    with timer.phase("trace"):
        pass
    assert "trace" in timer.summary()


def test_torch_cli_devices_flag(capsys):
    assert main(["--devices"]) == 0
    outp = capsys.readouterr().out
    assert "platform" in outp


@pytest.mark.parametrize("port", ["0", "8000"])
def test_torch_cli_preview_port_not_ported(port):
    with pytest.raises(NotImplementedError, match="A.18"):
        main(["--preview-port", port, "--device", "cpu"])


def test_torch_metrics_equal_sfvp_tpu():
    pytest.importorskip("jax")
    from sfvp_tpu.utils import metrics as jm

    g = np.random.default_rng(3)
    a = g.random((16, 16, 3), np.float32)
    b = a + g.normal(0.0, 0.01, a.shape).astype(np.float32)
    var = g.random((16, 16, 3))
    assert metrics.rmse(a, b) == jm.rmse(a, b)
    assert metrics.relative_rmse(a, b) == jm.relative_rmse(a, b)
    assert metrics.relative_rmse(a, np.zeros_like(a)) == jm.relative_rmse(
        a, np.zeros_like(a))
    assert metrics.mc_expected_rmse(var, 8) == jm.mc_expected_rmse(var, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics.rmse(a, b[:8])


def test_torch_step_timer_ema_equals_sfvp_tpu(monkeypatch):
    pytest.importorskip("jax")
    from sfvp_tpu.utils import profiling as jp

    def run(module):
        ticks = itertools.accumulate([0.0, 0.5, 0.25, 1.0, 3.0, 0.125,
                                      2.0, 0.75, 0.5, 0.0625])
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer(alpha=0.3)
        for name in ("trace", "shade", "trace", "trace", "shade"):
            with timer.phase(name):
                pass
        return timer.ema, timer.summary()

    assert run(profiling) == run(jp)


def test_torch_utils_import_no_jax():
    """The utilities are the port's own: no jax, no sfvp_tpu."""
    import sfvp_tpu_torch.utils as u

    root = os.path.dirname(u.__file__)
    for name in ("profiling.py", "diagnostics.py", "metrics.py"):
        src = open(os.path.join(root, name)).read()
        assert "import jax" not in src and "sfvp_tpu." not in src
