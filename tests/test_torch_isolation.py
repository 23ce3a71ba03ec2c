"""The port stands alone and never hides the device.

  * no module of repro_torch, nor chip_smoke.py, imports jax or repro
    (an AST walk over the sources);
  * a replay, a cold query and a serve run driven through repro_torch
    with device="cpu" leave neither jax nor repro in sys.modules;
  * an entry point left on its default device ("cuda") raises when there
    is no card, instead of running on the CPU.
"""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(REPO)} imports {mod}"


_DRIVE = textwrap.dedent("""
    import sys, tempfile
    import numpy as np
    from repro_torch.alerts import AnalyticsStage, ThresholdRule, WindowSpec
    from repro_torch.query import AggQuery, QueryPlane
    from repro_torch.store import StorePlane

    rng = np.random.default_rng(0)
    stage = AnalyticsStage(WindowSpec(size_s=60.0),
                           [ThresholdRule("vol", threshold=3.0)])
    with tempfile.TemporaryDirectory() as d:
        store = StorePlane(d, columnar=True, segment_bytes=1 << 13,
                           block_rows=32, analytics=stage, device="cpu")
        plane = QueryPlane(stage, log=store.log, max_windows_per_key=3,
                           columnar_lanes=True, device="cpu")
        t = np.sort(rng.uniform(0, 1200, 400))
        store.append_documents([(f"d{i}", {"channel": "news",
                                           "published_at": float(x)})
                                for i, x in enumerate(t)])
        store.log.roll()
        res = store.replay.replay_log(0, watermark=1e6)
        assert res["columnar"] and res["events"] == 400 and res["alerts"]
        q = plane.query(AggQuery(channel="news", start=0.0, end=1200.0))
        assert q.source == "mixed", q.source
        store.close()

    import torch
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_arch("qwen2.5-3b").smoke
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, ServeConfig(max_batch=2, max_seq_len=64),
                      eos_id=-1, device="cpu")
    for i in range(3):
        eng.submit(Request(rid=i, prompt_tokens=[1, 5 + i, 9], max_new_tokens=3))
    assert len(eng.run_until_drained()) == 3
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print("LEAKED", leaked)
""")


def test_driving_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _DRIVE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def _replay_launch(tmp_path):
    from repro_torch.alerts import AnalyticsStage, WindowSpec
    from repro_torch.store import EventLog, ReplayEngine
    log = EventLog(str(tmp_path / "log"))
    log.append([{"id": "d0", "doc": {"channel": "news",
                                     "published_at": 1.0}}])
    stage = AnalyticsStage(WindowSpec(size_s=60.0), [])
    ReplayEngine(log=log, analytics=stage).replay_log(0)


def _reduce_launch(tmp_path):
    from repro_torch.alerts.batch import reduce_events
    from repro_torch.alerts.windows import WindowSpec
    reduce_events([("news", 1.0, 1.0)], WindowSpec(size_s=60.0))


def _kernel_launch(tmp_path):
    from repro_torch.kernels.window_reduce import window_reduce
    window_reduce(np.ones(3, np.float32), np.zeros(3, np.int32), 1)


def _store_plane(tmp_path):
    from repro_torch.store import StorePlane
    StorePlane(str(tmp_path / "store"))


def _query_engine(tmp_path):
    from repro_torch.query import MaterializedStore, QueryEngine
    QueryEngine(MaterializedStore())


def _model_init(tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    import torch
    build_model(get_arch("qwen2.5-3b").smoke).init_params(torch.Generator())


def _model_cache(tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    build_model(get_arch("qwen2.5-3b").smoke).init_cache(1, 8)


def _serve_engine(tmp_path):
    from repro_torch.config import ServeConfig
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    import torch
    model = build_model(get_arch("qwen2.5-3b").smoke)
    params = model.init_params(torch.Generator(), "cpu")
    ServeEngine(model, params, ServeConfig(max_batch=1, max_seq_len=8))


def _serve_launcher(tmp_path):
    from repro_torch.launch.serve import main
    main(["--requests", "1", "--max-new", "1"])


@pytest.mark.parametrize("entry", [_replay_launch, _reduce_launch,
                                   _kernel_launch, _store_plane,
                                   _query_engine, _model_init,
                                   _model_cache, _serve_engine,
                                   _serve_launcher],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_default_device_raises_without_a_card(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry(tmp_path)
