"""The port's packaging: ``container/Dockerfile.torch`` and the GPU chart
``deploy/helm/dynamo-platform-gpu/`` (neither built nor installed here: the
chart's templates are rendered from its ``values.yaml`` and parsed, the
image's Dockerfile read), and the metrics stack ``deploy/metrics/`` serving
the port unchanged: the port's frontend and metrics service, after a few
requests on the CPU, expose every series the Grafana dashboard and the
Prometheus jobs name."""

import asyncio
import importlib
import itertools
import json
import re
from pathlib import Path

import httpx
import pytest
import yaml

from dynamo_tpu_torch.cli import dynctl
from dynamo_tpu_torch.cli.run import parse_args
from dynamo_tpu_torch.deploy import crds

ROOT = Path(__file__).resolve().parent.parent
CHART = ROOT / "deploy" / "helm" / "dynamo-platform-gpu"
DOCKERFILE = ROOT / "container" / "Dockerfile.torch"
METRICS = ROOT / "deploy" / "metrics"
MODEL_DIR = ROOT / "tests" / "data" / "tiny-chat-model"
_names = itertools.count()


def values() -> dict:
    return yaml.safe_load((CHART / "values.yaml").read_text())


def render(template: str, vals: dict, release: str = "rel") -> str:
    """Helm's substitution for the only forms the chart uses:
    ``{{ .Values.a.b }}`` and ``{{ .Release.Name }}``."""

    def sub(m):
        expr = m.group(1).strip()
        if expr == ".Release.Name":
            return release
        assert expr.startswith(".Values."), expr
        node = vals
        for part in expr.removeprefix(".Values.").split("."):
            node = node[part]
        return str(node)

    out = re.sub(r"\{\{(.*?)\}\}", sub, template)
    assert "{{" not in out
    return out


def rendered() -> dict[str, list[dict]]:
    vals = values()
    return {p.name: [d for d in yaml.safe_load_all(render(p.read_text(), vals)) if d]
            for p in sorted((CHART / "templates").glob("*.yaml"))}


def containers(docs: list[dict]) -> list[dict]:
    return [c for d in docs if d["kind"] == "Deployment"
            for c in d["spec"]["template"]["spec"]["containers"]]


def test_the_chart_renders_and_parses():
    docs = rendered()
    assert set(docs) == {"controlplane.yaml", "frontend.yaml", "worker.yaml"}
    kinds = sorted(d["kind"] for ds in docs.values() for d in ds)
    assert kinds == ["Deployment", "Deployment", "Deployment", "Service", "Service"]
    chart = yaml.safe_load((CHART / "Chart.yaml").read_text())
    assert chart["apiVersion"] == "v2" and chart["version"]


def test_the_worker_asks_for_gpus_and_no_tpu():
    vals = values()
    gpu = str(vals["worker"]["resources"]["gpu"])
    (worker,) = containers(rendered()["worker.yaml"])
    assert worker["resources"]["requests"]["nvidia.com/gpu"] == gpu
    assert worker["resources"]["limits"]["nvidia.com/gpu"] == gpu
    (deployment,) = [d for d in rendered()["worker.yaml"] if d["kind"] == "Deployment"]
    assert "nodeSelector" not in deployment["spec"]["template"]["spec"]
    text = "".join(p.read_text() for p in CHART.rglob("*.yaml"))
    assert "google.com/tpu" not in text and "tpu_topology" not in text
    args = parse_args(["run", *worker["args"]])
    assert args.io == ["in=none", "out=torch"]
    assert args.tensor_parallel_size == int(gpu)
    assert args.model_path == vals["model"]["path"]
    assert args.num_blocks == vals["worker"]["engine"]["numBlocks"]


def test_every_command_parses_with_the_port_cli(monkeypatch):
    docs = rendered()
    (frontend,) = containers(docs["frontend.yaml"])
    assert frontend["command"] == ["python", "-m", "dynamo_tpu_torch.cli.run", "run"]
    args = parse_args(["run", *frontend["args"]])
    assert args.io == ["in=http", "out=dyn"]
    assert args.router_mode == values()["frontend"]["routerMode"]
    (cp,) = containers(docs["controlplane.yaml"])
    assert cp["command"][:3] == ["python", "-m", "dynamo_tpu_torch.cli.dynctl"]
    seen = []

    async def fake_amain(parsed):
        seen.append(parsed)
        return 0

    monkeypatch.setattr(dynctl, "_amain", fake_amain)
    assert dynctl.main([*cp["command"][3:], *cp["args"]]) == 0
    assert (seen[0].cmd, seen[0].host, seen[0].port) == ("serve", "0.0.0.0", 2379)


def named_modules() -> set[str]:
    """Every ``python -m`` module the chart and the Dockerfile name."""
    text = DOCKERFILE.read_text() + "".join(p.read_text() for p in CHART.rglob("*.yaml"))
    mods = set(re.findall(r"python\s+-m\s+([\w.]+)", text))
    mods |= set(re.findall(r'"-m",\s*"([\w.]+)"', text))
    return mods


def test_every_named_module_is_the_port():
    mods = named_modules()
    assert {"dynamo_tpu_torch.cli.run", "dynamo_tpu_torch.cli.dynctl"} <= mods
    for name in mods:
        assert name.split(".")[0] == "dynamo_tpu_torch", name
        importlib.import_module(name)


def test_the_dockerfile_copies_the_port_and_installs_no_jax():
    text = DOCKERFILE.read_text()
    base = re.search(r"^FROM\s+(\S+)", text, re.M).group(1)
    assert base.startswith("nvidia/cuda:12.") and "devel" in base
    copies = re.findall(r"^COPY\s+(\S+)\s+\S+$", text, re.M)
    assert copies == ["pyproject.toml", "dynamo_tpu_torch"]
    for src in copies:
        assert (ROOT / src).exists(), src
    run_lines = " ".join(re.findall(r"^RUN\s+(.*?)(?<!\\)$", text, re.M | re.S))
    assert "jax" not in run_lines.lower()
    assert re.search(r"pip install .*torch --index-url \$\{TORCH_INDEX_URL\}", text)
    assert re.search(r"TORCH_INDEX_URL=https://download\.pytorch\.org/whl/cu12\d", text)
    assert "python3.12" in text
    assert re.search(r'^CMD \["python", "-m", "dynamo_tpu_torch\.cli\.run", "--help"\]$',
                     text, re.M)


def test_the_image_is_the_operator_default():
    vals = values()
    assert f"{vals['image']['repository']}:{vals['image']['tag']}" == crds.DEFAULT_IMAGE
    tags = re.findall(r"docker build .*-t (\S+)", DOCKERFILE.read_text())
    assert tags == [crds.DEFAULT_IMAGE]
    runs = re.findall(r"docker run [^\n]*?(dynamo-tpu-torch\S*)", DOCKERFILE.read_text())
    assert runs and set(runs) == {crds.DEFAULT_IMAGE}


# -- deploy/metrics serves the port as it is ------------------------------------

def dashboard_series() -> set[str]:
    exprs = []

    def walk(x):
        if isinstance(x, dict):
            for k, v in x.items():
                exprs.append(v) if k == "expr" else walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(json.loads((METRICS / "grafana-dashboard.json").read_text()))
    assert exprs
    return {re.sub(r"_(bucket|sum|count)$", "", s)
            for e in exprs for s in re.findall(r"\bdyn_[a-z0-9_]+", e)}


def prometheus_jobs() -> dict[str, str]:
    """Job name -> the target port it scrapes."""
    conf = yaml.safe_load((METRICS / "prometheus.yml").read_text())
    return {job["job_name"]: job["static_configs"][0]["targets"][0].rsplit(":", 1)[1]
            for job in conf["scrape_configs"]}


def sampled(text: str, name: str) -> bool:
    """A sample line of the family (not only its HELP and TYPE lines)."""
    return re.search(rf"^{name}(_bucket|_sum|_count)?[{{ ]", text, re.M) is not None


async def poll(url: str, want: list[str], timeout: float = 30.0) -> str:
    """/metrics once every family in ``want`` has a sample."""
    deadline = asyncio.get_running_loop().time() + timeout
    async with httpx.AsyncClient(timeout=10) as client:
        while True:
            text = (await client.get(url)).text
            missing = [w for w in want if not sampled(text, w)]
            if not missing:
                return text
            if asyncio.get_running_loop().time() > deadline:
                raise AssertionError(f"{url} never showed {missing}")
            await asyncio.sleep(0.1)


async def test_the_metrics_stack_serves_the_port(monkeypatch):
    """A torch worker, a KV-routed frontend and the metrics service over one
    memory plane; after chats (one streamed) every dashboard series is on
    the /metrics of the process its job scrapes, and the jobs scrape the
    ports the port's frontend and metrics service default to."""
    from dynamo_tpu_torch.cli.run import parse_args as run_args
    from dynamo_tpu_torch.components.metrics_service import MetricsService
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.client import RouterMode
    from dynamo_tpu_torch.serve import serve_frontend, serve_worker
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    monkeypatch.setenv("DYN_TOPO", "0")
    jobs = prometheus_jobs()
    assert jobs == {"dynamo-frontend": str(run_args(["run", "in=http", "out=dyn", "--control-plane", "cp:2379"]).port),
                    "dynamo-metrics-service": str(MetricsService.__init__.__kwdefaults__["port"])}
    series = dashboard_series()
    front = sorted(s for s in series if s.startswith("dyn_llm_http_service_"))
    worker = sorted(s for s in series if s.startswith("dyn_worker_"))
    assert set(front) | set(worker) == series and front and worker

    rt = await DistributedRuntime.create(
        RuntimeConfig(control_plane=f"memory://packaging-{next(_names)}"))
    handle = service = watcher = metrics = None
    try:
        handle = await serve_worker(rt, MODEL_DIR, model_name="tiny", engine_kind="torch",
                                    device="cpu", num_blocks=64, max_batch_size=4,
                                    max_model_len=128, prefill_buckets=(32, 64))
        service, watcher = await serve_frontend(rt, host="127.0.0.1", port=0,
                                                router_mode=RouterMode.KV)
        metrics = MetricsService(rt.namespace("dynamo").component("backend"),
                                 host="127.0.0.1", port=0)
        await metrics.start()
        base = f"http://127.0.0.1:{service.port}"
        async with httpx.AsyncClient(base_url=base, timeout=60) as client:
            for _ in range(300):
                if (await client.get("/v1/models")).json().get("data"):
                    break
                await asyncio.sleep(0.1)
            for stream in (False, True, False):
                body = {"model": "tiny", "max_tokens": 6, "temperature": 0, "stream": stream,
                        "messages": [{"role": "user", "content": "hello there"}]}
                r = await client.post("/v1/chat/completions", json=body)
                assert r.status_code == 200, r.text
        await poll(f"{base}/metrics", front)
        await poll(f"http://127.0.0.1:{metrics.port}/metrics", worker)
    finally:
        if metrics:
            await metrics.stop()
        if watcher:
            await watcher.stop()
        if service:
            await service.stop()
        if handle:
            await handle.shutdown()
        await rt.close()


def test_the_gateway_selects_the_operator_label():
    """deploy/inference-gateway/ selects frontends by the label the port's
    operator stamps on every Deployment it renders."""
    from dynamo_tpu_torch.deploy import operator

    pool = yaml.safe_load((ROOT / "deploy" / "inference-gateway" / "inference-pool.yaml")
                          .read_text())
    ((key, value),) = pool["spec"]["selector"].items()
    assert (key, value) == ("dynamo.tpu/component-type", "frontend")
    assert key in Path(operator.__file__).read_text()
    importlib.import_module("dynamo_tpu_torch.components.router_service")


@pytest.mark.parametrize("path", sorted(CHART.rglob("*.yaml")), ids=lambda p: p.name)
def test_chart_files_name_no_jax_module(path):
    text = path.read_text()
    assert "dynamo_tpu." not in text and "out=jax" not in text
