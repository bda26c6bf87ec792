"""The port's deploy plane (dynamo_tpu_torch/deploy/, cli/deployctl.py, the
planner's KubernetesConnector) against the JAX package's.

Copies of tests/deploy/* (the api-store, the SDK graph → artifact →
reconciled Deployments path, the operator's reconcile, watch, conditions
and ingress) with the port's GPU resources, plus: manifests equal the
reference's for the same spec once ``{"gpu": n}`` / ``nvidia.com/gpu`` is
mapped to ``{"tpu": n}`` / ``google.com/tpu`` (no topology selector, the
port's image); ``Resources``' keys equal to the port's CRD schema; TPU keys
refused by name; the KubernetesConnector as tests/planner/test_planner.py
drives it; ``deployctl`` build → push → list → deploy against a live
api-store and ``FakeKube``."""

import asyncio
import copy
import json
import threading
from pathlib import Path

import pytest
import yaml
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from dynamo_tpu.deploy import crds as ref_crds
from dynamo_tpu.deploy import operator as ref_operator
from dynamo_tpu_torch.cli import deployctl
from dynamo_tpu_torch.deploy import (
    ComponentSpec,
    DynamoComponentDeployment,
    DynamoGraphDeployment,
    FakeKube,
    GraphReconciler,
    render_component_manifests,
)
from dynamo_tpu_torch.deploy import crds as port_crds
from dynamo_tpu_torch.deploy import operator as port_operator
from dynamo_tpu_torch.deploy.api_store import ArtifactStore, make_app
from dynamo_tpu_torch.deploy.crds import DEFAULT_IMAGE, Resources
from dynamo_tpu_torch.deploy.deployment import (
    build_graph_manifest,
    deploy_artifact,
    fetch_artifact,
    push_artifact,
    resolve_entry,
)
from dynamo_tpu_torch.deploy.operator import Operator, _condition, merge_conditions
from dynamo_tpu_torch.planner import PerfProfile, Planner, PlannerConfig, ProfilePoint
from dynamo_tpu_torch.planner.connectors import KubernetesConnector
from dynamo_tpu_torch.planner.planner import PlannerDecision, WorkloadSample
from dynamo_tpu_torch.sdk.graph import depends, endpoint, service

CRD_DIR = Path(__file__).resolve().parent.parent / "dynamo_tpu_torch" / "deploy" / "crds"

GRAPH_YAML = """
apiVersion: dynamo.tpu/v1alpha1
kind: DynamoGraphDeployment
metadata:
  name: llama-disagg
  namespace: serving
spec:
  services:
    frontend:
      componentType: frontend
      replicas: 1
      port: 8080
      envs: {DYN_LOG: info}
    decode-worker:
      componentType: worker
      replicas: 2
      resources: {gpu: 4, cpu: "8", memory: 32Gi}
      config: {numBlocks: 4096, blockSize: 16}
    prefill-worker:
      componentType: prefill-worker
      replicas: 4
      resources: {gpu: 1}
"""


def as_reference(text: str) -> str:
    """The same graph written for the reference: TPU chips for cards."""
    return text.replace("gpu:", "tpu:")


def gpu_view(manifest):
    """A reference manifest under the port's mapping: google.com/tpu →
    nvidia.com/gpu, the resource key tpu → gpu, the reference's image → the
    port's, the reference's runner module → the port's; no topology."""
    text = json.dumps(manifest, sort_keys=True)
    for a, b in (('"google.com/tpu"', '"nvidia.com/gpu"'), ('"tpu"', '"gpu"'),
                 ('"dynamo-tpu:latest"', f'"{DEFAULT_IMAGE}"'),
                 ('"dynamo_tpu.sdk.runner"', '"dynamo_tpu_torch.sdk.runner"')):
        text = text.replace(a, b)

    def drop_topology(node):
        if isinstance(node, dict):
            return {k: drop_topology(v) for k, v in node.items() if k != "tpu_topology"}
        if isinstance(node, list):
            return [drop_topology(v) for v in node]
        return node

    return drop_topology(json.loads(text))


# -- crds ---------------------------------------------------------------------

def test_graph_yaml_roundtrip():
    graph = DynamoGraphDeployment.from_yaml(GRAPH_YAML)
    assert graph.name == "llama-disagg"
    assert set(graph.services) == {"frontend", "decode-worker", "prefill-worker"}
    assert graph.services["decode-worker"].resources.gpu == 4
    again = DynamoGraphDeployment.from_manifest(graph.to_manifest())
    assert again.to_manifest() == graph.to_manifest()
    ref = ref_crds.DynamoGraphDeployment.from_yaml(as_reference(GRAPH_YAML))
    assert gpu_view(ref.to_manifest()) == graph.to_manifest()
    assert ComponentSpec().image == DEFAULT_IMAGE == "dynamo-tpu-torch:latest"
    assert (ref_crds.GROUP, ref_crds.VERSION) == ("dynamo.tpu", "v1alpha1")


def test_graph_validation_rejects_bad_component_type():
    graph = DynamoGraphDeployment(
        name="x", services={"svc": ComponentSpec(component_type="gpu-worker")})
    with pytest.raises(ValueError, match="componentType"):
        graph.validate()


@pytest.mark.parametrize("key", ["tpu", "tpu_topology", "tpuTopology"])
def test_tpu_resources_refused_by_name(key):
    with pytest.raises(ValueError, match=rf"\['{key}'\] name TPU chips"):
        Resources.from_dict({key: 4 if key == "tpu" else "2x2"})
    with pytest.raises(ValueError, match="TPU chips"):
        DynamoGraphDeployment.from_yaml(as_reference(GRAPH_YAML))


def test_resources_keys_are_the_crd_schema():
    """A structural schema prunes what it does not declare: the port's CRD
    declares exactly the fields ``Resources`` writes (``gpu``, no TPU
    fields), and the rest of the schema is the reference's."""
    ours = yaml.safe_load((CRD_DIR / "dynamographdeployments.yaml").read_text())
    ref = yaml.safe_load((CRD_DIR.parents[2] / "deploy" / "crds" /
                          "dynamographdeployments.yaml").read_text())
    path = ("spec", "versions", 0, "schema", "openAPIV3Schema", "properties", "spec",
            "properties", "services", "additionalProperties", "properties", "resources",
            "properties")

    def at(doc):
        for key in path:
            doc = doc[key]
        return doc

    assert set(at(ours)) == set(Resources().to_dict()) == {"cpu", "memory", "gpu"}
    assert at(ours)["gpu"] == {"type": "integer"}
    mapped = copy.deepcopy(ref)
    at(mapped).pop("tpu_topology")
    at(mapped)["gpu"] = at(mapped).pop("tpu")
    assert ours == mapped
    assert (CRD_DIR / "dynamocomponentdeployments.yaml").read_bytes() == (
        CRD_DIR.parents[2] / "deploy" / "crds" / "dynamocomponentdeployments.yaml").read_bytes()


# -- rendering ---------------------------------------------------------------

def test_render_gpu_worker_manifests_equal_the_references():
    def cd(mod, **resources):
        return mod.DynamoComponentDeployment(
            name="g-w", namespace="serving", graph="g", service_name="w",
            spec=mod.ComponentSpec(component_type="worker", replicas=2,
                                   resources=mod.Resources(**resources),
                                   config={"numBlocks": 128}))

    ours = render_component_manifests(cd(port_crds, gpu=4))
    ref = ref_operator.render_component_manifests(cd(ref_crds, tpu=4))
    manifests = {m["kind"]: m for m in ours}
    assert set(manifests) == {"ConfigMap", "Deployment"}
    dep = manifests["Deployment"]
    assert dep["spec"]["replicas"] == 2
    pod = dep["spec"]["template"]["spec"]
    container = pod["containers"][0]
    assert container["resources"]["requests"]["nvidia.com/gpu"] == "4"
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "4"
    assert "nodeSelector" not in pod
    assert any(e["name"] == "DYN_SERVICE_CONFIG" for e in container["env"])
    assert ours == gpu_view(ref)


def test_render_frontend_has_service_and_probe():
    cd = DynamoComponentDeployment(
        name="g-fe", namespace="serving", graph="g", service_name="fe",
        spec=ComponentSpec(component_type="frontend", port=8080))
    manifests = {m["kind"]: m for m in render_component_manifests(cd)}
    assert manifests["Service"]["spec"]["ports"][0]["port"] == 8080
    container = manifests["Deployment"]["spec"]["template"]["spec"]["containers"][0]
    assert container["readinessProbe"]["httpGet"]["port"] == 8080


async def test_reconcile_and_prune_equal_the_references():
    kube, ref_kube = FakeKube(), ref_operator.FakeKube()
    reconciler, ref_reconciler = GraphReconciler(kube), ref_operator.GraphReconciler(ref_kube)
    graph = DynamoGraphDeployment.from_yaml(GRAPH_YAML)
    ref_graph = ref_crds.DynamoGraphDeployment.from_yaml(as_reference(GRAPH_YAML))

    status = await reconciler.reconcile(graph)
    await ref_reconciler.reconcile(ref_graph)
    assert status["components"] == [
        "llama-disagg-decode-worker", "llama-disagg-frontend", "llama-disagg-prefill-worker"]
    assert kube.objects == {k: gpu_view(v) for k, v in ref_kube.objects.items()}
    kinds = [k for (k, _, _) in kube.objects]
    assert kinds.count("Deployment") == 3 and kinds.count("Service") == 1
    assert kinds.count("ConfigMap") == 1 and kinds.count("DynamoComponentDeployment") == 3

    del graph.services["prefill-worker"]
    status = await reconciler.reconcile(graph)
    assert status["pruned"] == 2
    assert ("Deployment", "serving", "llama-disagg-prefill-worker") not in kube.objects
    assert await reconciler.teardown(graph) > 0
    assert not [k for k in kube.objects if k[1] == "serving"]


async def test_fake_kube_label_listing():
    kube = FakeKube()
    for name, graph in (("a", "g1"), ("b", "g2")):
        await kube.apply({"kind": "Deployment", "metadata": {
            "name": name, "namespace": "ns", "labels": {"dynamo.tpu/graph": graph}}})
    got = await kube.list("Deployment", "ns", {"dynamo.tpu/graph": "g1"})
    assert [o["metadata"]["name"] for o in got] == ["a"]


async def _wait(predicate, timeout=5.0):
    for _ in range(int(timeout / 0.02)):
        if predicate():
            return True
        await asyncio.sleep(0.02)
    return predicate()


def _graph(name="g1", ingress=None):
    return DynamoGraphDeployment(name=name, services={
        "frontend": ComponentSpec(component_type="frontend", port=8080, ingress=ingress or {}),
        "worker": ComponentSpec(component_type="worker", replicas=2,
                                resources=Resources(gpu=1)),
    })


async def test_operator_watch_reconciles_and_sets_conditions():
    kube = FakeKube()
    op = Operator(kube, resync_s=600)
    op.start()
    try:
        await kube.apply(_graph().to_manifest())
        assert await _wait(lambda: ("Deployment", "default", "g1-worker") in kube.objects)
        key = ("DynamoGraphDeployment", "default", "g1")
        assert await _wait(lambda: kube.objects[key].get("status", {}).get("conditions"))
        status = kube.objects[key]["status"]
        conds = {c["type"]: c for c in status["conditions"]}
        assert conds["Ready"]["status"] == "False"
        assert conds["Progressing"]["status"] == "True"
        assert status["components"] == ["g1-frontend", "g1-worker"]
        kube.set_deployment_ready("default", "g1-frontend", 1)
        kube.set_deployment_ready("default", "g1-worker", 2)

        def is_ready():
            conds = {c["type"]: c for c in kube.objects[key].get("status", {}).get(
                "conditions", [])}
            return conds.get("Ready", {}).get("status") == "True"

        assert await _wait(is_ready)
    finally:
        await op.stop()


async def test_operator_teardown_on_delete():
    kube = FakeKube()
    op = Operator(kube, resync_s=600)
    op.start()
    try:
        await kube.apply(_graph().to_manifest())
        assert await _wait(lambda: ("Deployment", "default", "g1-worker") in kube.objects)
        await kube.delete("DynamoGraphDeployment", "default", "g1")
        assert await _wait(lambda: not any(k == "Deployment" for (k, _, _) in kube.objects))
    finally:
        await op.stop()


async def test_ingress_rendered_and_pruned():
    kube = FakeKube()
    rec = GraphReconciler(kube)
    graph = _graph(ingress={"host": "llm.example.com", "className": "nginx"})
    await rec.reconcile(graph)
    ing = kube.objects.get(("Ingress", "default", "g1-frontend"))
    rule = ing["spec"]["rules"][0]
    assert rule["host"] == "llm.example.com"
    assert rule["http"]["paths"][0]["backend"]["service"]["port"]["number"] == 8080
    assert ing["spec"]["ingressClassName"] == "nginx"
    graph.services["frontend"].ingress = {}
    await rec.reconcile(graph)
    assert ("Ingress", "default", "g1-frontend") not in kube.objects


def test_condition_transition_time_stable():
    old = [_condition("Ready", False, "Pending", "0/2")]
    old[0]["lastTransitionTime"] = "2020-01-01T00:00:00Z"
    merged = merge_conditions(old, [_condition("Ready", False, "Pending", "1/2")])
    assert merged[0]["lastTransitionTime"] == "2020-01-01T00:00:00Z"
    merged = merge_conditions(old, [_condition("Ready", True, "AllReady", "2/2")])
    assert merged[0]["lastTransitionTime"] != "2020-01-01T00:00:00Z"


# -- api-store and the SDK path ------------------------------------------------

async def test_api_store_crud(tmp_path):
    client = TestClient(TestServer(make_app(ArtifactStore(tmp_path))))
    await client.start_server()
    try:
        record = {"name": "llama-disagg", "version": "v1",
                  "manifest": {"kind": "DynamoGraphDeployment", "spec": {"services": {}}}}
        assert (await client.post("/api/v1/graphs", json=record)).status == 201
        assert (await client.post("/api/v1/graphs", json=record)).status == 409
        bad = dict(record, name="../../etc/passwd")
        assert (await client.post("/api/v1/graphs", json=bad)).status == 400
        r = await client.get("/api/v1/graphs")
        assert await r.json() == [{"name": "llama-disagg", "versions": ["v1"]}]
        body = await (await client.get("/api/v1/graphs/llama-disagg/v1")).json()
        assert body["manifest"]["kind"] == "DynamoGraphDeployment" and body["created_at"] > 0
        assert (await client.delete("/api/v1/graphs/llama-disagg/v1")).status == 200
        assert (await client.get("/api/v1/graphs/llama-disagg/v1")).status == 404
    finally:
        await client.close()


@service(name="chat-worker", workers=3, resources={"gpu": 4})
class Worker:
    @endpoint()
    async def generate(self, request, ctx):
        yield {"ok": True}


@service(name="chat-frontend", component_type="frontend")
class Frontend:
    worker = depends(Worker)

    @endpoint()
    async def generate(self, request, ctx):
        yield {"ok": True}


def test_build_graph_manifest_renders_closure():
    manifest = build_graph_manifest(Frontend, name="chat", image="img:1")
    services = manifest["spec"]["services"]
    assert set(services) == {"chat-frontend", "chat-worker"}
    worker = services["chat-worker"]
    assert (worker["replicas"], worker["componentType"]) == (3, "worker")
    assert worker["resources"] == {"cpu": "1", "memory": "2Gi", "gpu": 4}
    assert worker["command"] == ["python", "-m", "dynamo_tpu_torch.sdk.runner"]
    assert worker["args"][0].endswith(":Worker")
    assert services["chat-frontend"]["image"] == "img:1"
    assert build_graph_manifest(Frontend)["spec"]["services"]["chat-worker"]["image"] == \
        DEFAULT_IMAGE
    assert resolve_entry(f"{Frontend.__module__}:Frontend") is Frontend
    with pytest.raises(ValueError, match="module:ClassName"):
        resolve_entry("no-colon-here")


async def test_sdk_graph_to_reconciled_deployments(tmp_path):
    client = TestClient(TestServer(make_app(ArtifactStore(tmp_path))))
    await client.start_server()
    store_url = str(client.make_url("")).rstrip("/")
    kube = FakeKube()
    op = Operator(kube, resync_s=600)
    op.start()
    try:
        await push_artifact(store_url, "chat", "v1", build_graph_manifest(Frontend, name="chat"))
        record = await fetch_artifact(store_url, "chat", "v1")
        assert (await deploy_artifact(kube, record))["metadata"]["name"] == "chat"

        async def deployment(name):
            assert await _wait(lambda: ("Deployment", "default", name) in kube.objects)
            return kube.objects[("Deployment", "default", name)]

        worker = await deployment("chat-chat-worker")
        assert worker["spec"]["replicas"] == 3
        container = worker["spec"]["template"]["spec"]["containers"][0]
        assert container["command"] == ["python", "-m", "dynamo_tpu_torch.sdk.runner"]
        assert container["resources"]["limits"]["nvidia.com/gpu"] == "4"
        assert container["image"] == DEFAULT_IMAGE
        assert (await deployment("chat-chat-frontend"))["spec"]["replicas"] == 1
        with pytest.raises(KeyError, match="absent:v9"):
            await fetch_artifact(store_url, "absent", "v9")
    finally:
        await op.stop()
        await client.close()


class StoreThread:
    """The api-store served on its own event loop in a thread, for the
    deployctl CLI (which runs its own ``asyncio.run``)."""

    def __init__(self, root):
        self.loop = asyncio.new_event_loop()
        self.ready = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(root,), daemon=True)
        self.thread.start()
        assert self.ready.wait(10)

    def _run(self, root):
        asyncio.set_event_loop(self.loop)
        runner = web.AppRunner(make_app(ArtifactStore(root)), access_log=None)
        self.loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        self.loop.run_until_complete(site.start())
        self.url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        self.runner = runner
        self.ready.set()
        self.loop.run_forever()
        self.loop.run_until_complete(runner.cleanup())
        self.loop.close()

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def test_deployctl_build_push_list_deploy(tmp_path, monkeypatch, capsys):
    kube = FakeKube()
    monkeypatch.setattr(port_operator, "KubectlClient", lambda: kube)
    store = StoreThread(tmp_path / "store")
    entry = "dynamo_tpu_torch.examples.hello_world.hello_world:Frontend"
    try:
        out = tmp_path / "graph.json"
        assert deployctl.main(["build", entry, "--out", str(out)]) == 0
        manifest = json.loads(out.read_text())
        assert {s["image"] for s in manifest["spec"]["services"].values()} == {DEFAULT_IMAGE}
        assert deployctl.main(["push", str(out), "--store", store.url, "--name", "hello",
                               "--version", "v1"]) == 0
        assert deployctl.main(["build", entry, "--store", store.url, "--name", "hello",
                               "--version", "v2"]) == 0
        capsys.readouterr()
        assert deployctl.main(["list", "--store", store.url]) == 0
        assert capsys.readouterr().out.strip() == "hello\tv1,v2"
        assert deployctl.main(["deploy", "hello", "v2", "--store", store.url,
                               "--namespace", "serving"]) == 0
    finally:
        store.close()
    graph = kube.objects[("DynamoGraphDeployment", "serving", "hello")]
    assert set(graph["spec"]["services"]) == set(manifest["spec"]["services"])
    status = asyncio.run(GraphReconciler(kube).reconcile(
        DynamoGraphDeployment.from_manifest(graph)))
    assert len(status["components"]) == len(manifest["spec"]["services"])


# -- the planner's Kubernetes connector ----------------------------------------

def profile():
    """tests/planner/test_planner.py's profile."""
    return PerfProfile([
        ProfilePoint(isl=512, osl=64, prefill_tok_s=10_000, decode_tok_s=1_000,
                     ttft_s=0.1, itl_s=0.02),
        ProfilePoint(isl=2048, osl=128, prefill_tok_s=8_000, decode_tok_s=800,
                     ttft_s=0.3, itl_s=0.025),
    ])


async def test_kubernetes_connector_drives_operator():
    kube = FakeKube()
    graph = DynamoGraphDeployment(name="graph", services={
        "prefill-worker": ComponentSpec(component_type="worker", replicas=1),
        "decode-worker": ComponentSpec(component_type="worker", replicas=1)})
    op = Operator(kube, resync_s=600)
    op.start()

    def replicas(name):
        obj = kube.objects.get(("Deployment", "default", name))
        return None if obj is None else obj["spec"]["replicas"]

    try:
        await kube.apply(graph.to_manifest())
        assert await _wait(lambda: replicas("graph-prefill-worker") == 1)
        assert await _wait(lambda: replicas("graph-decode-worker") == 1)
        planner = Planner(profile(), KubernetesConnector(kube, graph="graph"), PlannerConfig(
            predictor="constant", max_prefill=3, max_decode=2, scale_down_headroom=1.0))
        decision = await planner.step(WorkloadSample(request_rate=1000, avg_isl=512,
                                                     avg_osl=64))
        assert (decision.num_prefill, decision.num_decode) != (1, 1)
        assert await _wait(lambda: (replicas("graph-prefill-worker"),
                                    replicas("graph-decode-worker"))
                           == (decision.num_prefill, decision.num_decode)), \
            "operator never applied the planner's replicas"
        spec = kube.objects[("DynamoGraphDeployment", "default", "graph")]["spec"]
        assert spec["services"]["prefill-worker"]["replicas"] == decision.num_prefill
        assert spec["services"]["decode-worker"]["replicas"] == decision.num_decode
    finally:
        await op.stop()


async def test_kubernetes_connector_missing_graph_raises():
    connector = KubernetesConnector(FakeKube(), graph="absent")
    with pytest.raises(ValueError, match="absent"):
        await connector.scale(PlannerDecision(num_prefill=1, num_decode=1))
