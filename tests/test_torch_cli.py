"""The port's CLI against the reference's: each ``dynctl`` verb prints what
the reference's prints on the same control-plane state (one TCP
control-plane server, both tools its clients; per-process ids, durations and
paths masked), ``topology`` included, and ``run`` answers
``in=batch:FILE`` (``out=torch --device cpu`` against the reference's
``out=jax``, ``out=mocker`` against its mocker) and ``in=text`` through the
whole pipeline."""

import argparse
import asyncio
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import httpx
import pytest

from dynamo_tpu.cli import dynctl as ref_dynctl
from dynamo_tpu_torch.cli import dynctl
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime.controlplane.server import ControlPlaneServer
from dynamo_tpu_torch.serve import serve_frontend, serve_worker
from dynamo_tpu_torch.utils.config import RuntimeConfig

ROOT = Path(__file__).resolve().parent.parent
MODEL_DIR = ROOT / "tests" / "data" / "tiny-chat-model"


async def stack(cp_port: int, models: dict[str, int], token_delay_s: float = 0.02):
    """Echo workers (``models``: name -> workers) and a frontend over the
    TCP control plane."""
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane=f"127.0.0.1:{cp_port}"))
    workers = []
    for name, n in models.items():
        for _ in range(n):
            w = await serve_worker(rt, MODEL_DIR, model_name=name, engine_kind="echo")
            w.engine.token_delay_s = token_delay_s
            workers.append(w)
    service, watcher = await serve_frontend(rt, host="127.0.0.1", port=0)
    return rt, workers, service, watcher


async def teardown(rt, workers, service, watcher) -> None:
    await watcher.stop()
    await service.stop()
    for w in workers:
        await w.shutdown()
    await rt.close()


async def both(capsys, **ns) -> tuple[tuple[int, str], tuple[int, str]]:
    """Run one verb through the port's dynctl, then the reference's."""
    out = []
    for mod in (dynctl, ref_dynctl):
        rc = await mod._amain(argparse.Namespace(**ns))
        out.append((rc, capsys.readouterr().out))
    return out[0], out[1]


async def wait_models(client, names, timeout=10.0):
    for _ in range(int(timeout / 0.05)):
        r = await client.get("/v1/models")
        if set(names) <= {m["id"] for m in r.json().get("data", [])}:
            return
        await asyncio.sleep(0.05)
    raise TimeoutError(f"models {names} never appeared")


async def test_dynctl_list_and_remove_verbs_print_as_the_reference(capsys):
    cp = ControlPlaneServer(port=0)
    await cp.start()
    addr = f"127.0.0.1:{cp.port}"
    parts = await stack(cp.port, {"tiny": 2, "other": 2})
    try:
        for verb in ("list-models", "list-instances"):
            ours, ref = await both(capsys, cmd=verb, control_plane=addr)
            assert ours == ref and ours[0] == 0
            assert len(ours[1].splitlines()) == 4, ours
        ours = await dynctl._amain(argparse.Namespace(cmd="remove-model", name="tiny",
                                                      control_plane=addr))
        ours_out = capsys.readouterr().out
        ref = await ref_dynctl._amain(argparse.Namespace(cmd="remove-model", name="other",
                                                         control_plane=addr))
        ref_out = capsys.readouterr().out
        assert (ours, ours_out) == (0, "removed 2 registration(s) for tiny\n")
        assert (ref, ref_out.replace("other", "tiny")) == (ours, ours_out)
        ours, ref = await both(capsys, cmd="list-models", control_plane=addr)
        assert ours == ref == (0, "(no models registered)\n")
    finally:
        await teardown(*parts)
        await cp.stop()


def masked(text: str) -> str:
    text = re.sub(r"\b[0-9a-f]{6,16}\b", "<id>", text)
    text = re.sub(r"duration=\S+", "duration=<s>", text)
    text = re.sub(r"hidden=\S+", "hidden=<s>", text)
    return re.sub(r": /\S+", ": <path>", text)


async def test_dynctl_drain_flight_and_migrate_print_as_the_reference(capsys):
    cp = ControlPlaneServer(port=0)
    await cp.start()
    addr = f"127.0.0.1:{cp.port}"
    rt, workers, service, watcher = await stack(cp.port, {"tiny": 4})
    try:
        async with httpx.AsyncClient(base_url=f"http://127.0.0.1:{service.port}") as client:
            await wait_models(client, ["tiny"])
            # flight dump of every instance: one line each
            ours, ref = await both(capsys, cmd="flight", action="dump", instance=None,
                                   timeout=10.0, control_plane=addr)
            assert ours[0] == ref[0] and masked(ours[1]) == masked(ref[1])
            assert len(ours[1].splitlines()) >= 4

            # migrate: no dispatcher owns an unknown id
            ours, ref = await both(capsys, cmd="migrate", request_id="no-such-request",
                                   dst=None, reason="manual", timeout=2.0, control_plane=addr)
            assert ours == ref and ours[0] == 1 and "no dispatcher owns" in ours[1]

            # migrate a live stream, destination picked by the coordinator
            outs = []
            for mod in (dynctl, ref_dynctl):
                trace = f"cafe{0:028x}"  # one id: the first stream has finished
                task = asyncio.ensure_future(client.post(
                    "/v1/chat/completions", headers={"x-request-id": trace}, timeout=30,
                    json={"model": "tiny", "max_tokens": 120,  # 2.4 s at 20 ms a token
                          "messages": [{"role": "user", "content": "one two three " * 20}]}))
                coord = watcher._pipelines["tiny"]["router"].migrations
                for _ in range(1000):
                    if coord.sessions():
                        break
                    await asyncio.sleep(0.005)
                await asyncio.sleep(0.05)
                rc = await mod._amain(argparse.Namespace(
                    cmd="migrate", request_id=trace, dst=None, reason="manual",
                    timeout=10.0, control_plane=addr))
                outs.append((rc, capsys.readouterr().out))
                r = await task
                assert r.status_code == 200
            assert outs[0][0] == outs[1][0] == 0, outs
            assert masked(outs[0][1]) == masked(outs[1][1])
            assert outs[0][1].startswith("migrated ")

            # drain: each tool empties one worker, which deregisters
            outs = []
            for mod, w in ((dynctl, workers[0]), (ref_dynctl, workers[1])):
                rc = await mod._amain(argparse.Namespace(
                    cmd="drain", instance=f"{w.service.instance.instance_id:016x}",
                    timeout=10.0, control_plane=addr))
                outs.append((rc, capsys.readouterr().out))
            assert outs[0][0] == outs[1][0] == 0, outs
            assert masked(outs[0][1]) == masked(outs[1][1])
            assert "deregistered=True" in outs[0][1]
            ours, ref = await both(capsys, cmd="drain", instance="ffffffffffffffff",
                                   timeout=2.0, control_plane=addr)
            assert ours == ref and ours[0] == 1
    finally:
        await teardown(rt, workers, service, watcher)
        await cp.stop()


async def test_topology_refuses_by_name(capsys, monkeypatch):
    """``topology`` no longer refuses: with the plane on, two workers'
    published cards print as the reference's dynctl prints them, as a table
    and as JSON."""
    monkeypatch.setenv("DYN_TOPO", "1")
    cp = ControlPlaneServer(port=0)
    await cp.start()
    addr = f"127.0.0.1:{cp.port}"
    parts = await stack(cp.port, {"tiny": 2})
    try:
        for _ in range(200):
            if len(parts[3].topology.nodes) == 2:
                break
            await asyncio.sleep(0.01)
        ours, ref = await both(capsys, cmd="topology", json=False, control_plane=addr)
        assert ours == ref and ours[0] == 0
        assert "informative=False links=1" in ours[1]
        assert len([line for line in ours[1].splitlines() if " local " in line]) == 1
        ours, ref = await both(capsys, cmd="topology", json=True, control_plane=addr)
        assert ours[0] == ref[0] == 0
        ours_map, ref_map = json.loads(ours[1]), json.loads(ref[1])
        ours_map.pop("age_s"), ref_map.pop("age_s")
        assert ours_map == ref_map and len(ours_map["nodes"]) == 2
    finally:
        await teardown(*parts)
        await cp.stop()


def test_parser_takes_the_reference_verbs():
    for argv in (["list-models"], ["list-instances"], ["remove-model", "m"],
                 ["drain", "ab", "--timeout", "3"], ["migrate", "rid"], ["migrate", "rid", "ab"],
                 ["flight", "dump"], ["flight", "dump", "ab"], ["topology", "--json"]):
        with pytest.raises(SystemExit) as exc:
            dynctl.main([*argv, "--help"])
        assert exc.value.code == 0


# -- run in=batch / in=text ---------------------------------------------------------


def run_cli(module: str, io: list[str], extra: list[str], stdin: str | None = None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", module, "run", *io, "--model-path", str(MODEL_DIR),
         "--context-length", "48", *extra],
        cwd=ROOT, env=env, text=True, stdin=subprocess.PIPE if stdin is not None else None,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_run_batch_and_text_answer_as_the_reference(tmp_path):
    batch = tmp_path / "prompts.jsonl"
    batch.write_text('abc\n{"prompt": "hello there"}\n\nsay something\n')
    procs = {
        "torch": run_cli("dynamo_tpu_torch.cli.run", [f"in=batch:{batch}", "out=torch"],
                         ["--device", "cpu"]),
        "jax": run_cli("dynamo_tpu.cli.run", [f"in=batch:{batch}", "out=jax"], []),
        "mocker": run_cli("dynamo_tpu_torch.cli.run", [f"in=batch:{batch}", "out=mocker"], []),
        "ref_mocker": run_cli("dynamo_tpu.cli.run", [f"in=batch:{batch}", "out=mocker"], []),
        "text": run_cli("dynamo_tpu_torch.cli.run", ["in=text", "out=torch"],
                        ["--device", "cpu"], stdin="abc\n\n"),
    }
    outs = {}
    for name, proc in procs.items():
        out, err = proc.communicate("abc\n\n" if name == "text" else None, timeout=240)
        assert proc.returncode == 0, (name, err[-3000:])
        outs[name] = out
    lines = [json.loads(line) for line in outs["torch"].splitlines()]
    assert [d["prompt"] for d in lines] == ["abc", "hello there", "say something"]
    # the tiny chat model's greedy continuation: a token counter
    assert lines[0]["response"].startswith("!\"#$%&'()")
    assert outs["torch"] == outs["jax"]
    assert outs["mocker"] == outs["ref_mocker"]
    assert [json.loads(line)["prompt"] for line in outs["mocker"].splitlines()] == \
        ["abc", "hello there", "say something"]
    assert outs["text"] == lines[0]["response"] + "\n"
