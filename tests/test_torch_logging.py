"""The port's structured logger against the JAX package's
(``src/repro/obs/logging.py``): the same calls give the same records apart
from their time stamps, on both sides' in-memory records and JSONL files;
and the training loop's human lines are the same whether it logs to a
plain callable or to a ``StructuredLogger``.
"""
import json
import re

import pytest

from repro.obs import logging as JL
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.obs import logging as TL
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step_builder import build_train_step

import torch_cores

torch_cores.share_cores()

CALLS = [  # (method, event, msg, fields)
    ("debug", "probe", None, {"x": 1}),
    ("info", "step", "[loop] step 0 loss=1.0000", {"step": 0, "loss": 1.0}),
    ("warning", "straggler", "slow", {"dt_s": 0.5, "median_s": 0.1}),
    ("error", "oom", "out of memory", {"bytes": 1 << 30, "where": ("a", 2)}),
    ("info", "quiet", None, {}),
]


def _drive(logger):
    for method, event, msg, fields in CALLS:
        getattr(logger, method)(event, msg, **fields)
    logger("a plain line")  # the callable surface
    logger.log("info", "direct", "via log()", k="v")


def _no_ts(records):
    assert all(isinstance(r.pop("ts"), float) for r in records)
    return records


@pytest.mark.parametrize("min_level", ["debug", "info", "warning", "error"])
def test_records_and_human_lines_equal_reference(min_level):
    """Level filtering, records and the human sink, call by call."""
    lines_t, lines_j = [], []
    t = TL.StructuredLogger("loop", sink=lines_t.append, min_level=min_level)
    j = JL.StructuredLogger("loop", sink=lines_j.append, min_level=min_level)
    _drive(t)
    _drive(j)
    assert lines_t == lines_j
    assert _no_ts(t.records) == _no_ts(j.records)
    assert len(t.records) == {"debug": 7, "info": 6, "warning": 2, "error": 1}[min_level]


def test_jsonl_files_equal_reference(tmp_path):
    """Both sides append the same JSON lines (apart from ``ts``), silenced
    sinks print nothing, ``max_records`` bounds memory but not the file."""
    paths = {}
    for name, mod in (("torch", TL), ("jax", JL)):
        paths[name] = tmp_path / name / "log.jsonl"
        lg = mod.StructuredLogger("run", sink=None, jsonl_path=str(paths[name]),
                                  max_records=3)
        _drive(lg)
        lg.close()
        assert len(lg.records) == 3
    rows = {k: _no_ts([json.loads(line) for line in p.read_text().splitlines()])
            for k, p in paths.items()}
    assert rows["torch"] == rows["jax"] and len(rows["torch"]) == 7
    assert rows["torch"][3]["where"] == ["a", 2]


def test_as_logger_wraps_a_callable_and_passes_a_logger():
    lines = []
    lg = TL.as_logger(lines.append, name="launch")
    jlg = JL.as_logger([].append, name="launch")
    assert lg.name == jlg.name == "launch" and TL.as_logger(lg) is lg
    lg.info("resume", "[loop] resumed", step=2)
    lg("plain")
    assert lines == ["[loop] resumed", "plain"]
    assert [r["event"] for r in lg.records] == ["resume", "log"]
    assert obs.as_logger is TL.as_logger and obs.StructuredLogger is TL.StructuredLogger


def test_telemetry_carries_a_logger():
    tel = obs.Telemetry(name="train")
    assert isinstance(tel.log, TL.StructuredLogger) and tel.log.name == "train"
    obs.NULL_TELEMETRY.log.error("x", "dropped")  # silent, nothing kept
    assert obs.NULL_TELEMETRY.log.records == []


def _loop_lines(log):
    cfg = reduced(get_config("mistral-7b"), num_kv_heads=2, dtype="float32")
    shape = ShapeConfig("tiny", 32, 2, "train")
    art = build_train_step(cfg, MemoryPlan(4, 2, n_persist=4, grad_compress="int8_ef"),
                           "cpu", shape)
    train_loop(art, SyntheticTokenPipeline(cfg, shape, seed=0), None,
               LoopConfig(total_steps=3, log_every=1), log=log)


def test_train_loop_human_lines_unchanged_under_a_structured_logger():
    """``train_loop(log=...)`` with a callable and with a StructuredLogger
    whose sink is a callable: the same human lines (their millisecond
    counts aside), and each line is a record's ``msg`` with its fields."""
    plain, sunk = [], []
    _loop_lines(plain.append)
    lg = TL.StructuredLogger("loop", sink=sunk.append)
    _loop_lines(lg)
    ms = re.compile(r"\(\d+ ms\)")
    assert [ms.sub("", x) for x in plain] == [ms.sub("", x) for x in sunk]
    assert len(sunk) == 3 and all(x.startswith("[loop] step ") for x in sunk)
    steps = [r for r in lg.records if r["event"] == "step"]
    assert [r["msg"] for r in steps] == sunk
    assert [r["step"] for r in steps] == [0, 1, 2] and all(r["ef_norm"] > 0 for r in steps)
    (sync,) = [r for r in lg.records if r["event"] == "sync_config"]
    assert sync["strategy"] == "xla" and sync["world"] == 1 and "msg" not in sync
