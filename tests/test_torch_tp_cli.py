"""``run ... out=torch --tensor-parallel-size 2`` on the CPU: the CLI's
worker (``serve_worker`` over the in-process plane) serves from a tp = 2
engine, rank 0 in the CLI's process and its shard worker a child, and
answers every prompt of a batch file; a model whose vocabulary tp does not
divide (the tiny chat model's 481) is refused with the reference's words."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "tests" / "data" / "tiny-chat-model"


def model_dir(tmp_path: Path, **config) -> Path:
    """The tiny chat model's tokenizer beside a config of 8 heads (4 kv)
    and the given changes; no weights (random from the seed)."""
    out = tmp_path / "model"
    out.mkdir()
    for name in ("tokenizer.json", "tokenizer_config.json"):
        (out / name).write_bytes((TINY / name).read_bytes())
    cfg = json.loads((TINY / "config.json").read_text())
    cfg.update(num_attention_heads=8, num_key_value_heads=4, **config)
    (out / "config.json").write_text(json.dumps(cfg))
    return out


def run(model: Path, batch: Path, *flags: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["DYN_LOG"] = "info"
    return subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "run", f"in=batch:{batch}",
         "out=torch", "--model-path", str(model), "--device", "cpu", "--context-length", "40",
         *flags], capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)


def test_cli_serves_a_batch_on_a_tp_mesh(tmp_path):
    batch = tmp_path / "prompts.jsonl"
    batch.write_text('abc\n{"prompt": "hello there"}\nsay something\n')
    out = run(model_dir(tmp_path, vocab_size=512), batch, "--tensor-parallel-size", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [d["prompt"] for d in lines] == ["abc", "hello there", "say something"]
    assert all(d["response"] for d in lines)
    assert "tp=2" in out.stderr and "1 shard workers" in out.stderr


def test_cli_refuses_an_uneven_vocabulary(tmp_path):
    batch = tmp_path / "prompts.jsonl"
    batch.write_text("abc\n")
    out = run(model_dir(tmp_path), batch, "--tensor-parallel-size", "2")
    assert out.returncode != 0
    assert ("which implies that the global size of its dimension 0 should be divisible by 2, "
            "but it is equal to 481") in out.stderr
