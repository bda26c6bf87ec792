"""Graph artifact registry ("api-store"; reference: deploy/cloud/api-store —
the FastAPI registry for built graph packages).

Stores named+versioned graph artifacts (the deployment manifest plus an
optional opaque archive) on disk, with an aiohttp JSON API:

    POST   /api/v1/graphs                  {"name","version","manifest",...}
    GET    /api/v1/graphs                  → [{name, versions: [...]}]
    GET    /api/v1/graphs/{name}           → version list
    GET    /api/v1/graphs/{name}/{version} → stored record
    DELETE /api/v1/graphs/{name}/{version}
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path

from aiohttp import web

from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger("deploy.api_store")

_NAME_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9._-]{0,127}$")


class ArtifactStore:
    """Disk-backed registry: one JSON record per (name, version)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str, version: str) -> Path:
        for part in (name, version):
            if not _NAME_RE.match(part):
                raise ValueError(f"invalid name/version {part!r}")
        return self.root / name / f"{version}.json"

    def put(self, name: str, version: str, record: dict) -> dict:
        path = self._path(name, version)
        if path.exists():
            raise FileExistsError(f"{name}:{version} already exists")
        path.parent.mkdir(parents=True, exist_ok=True)
        stored = {**record, "name": name, "version": version, "created_at": time.time()}
        path.write_text(json.dumps(stored, indent=2, sort_keys=True))
        return stored

    def get(self, name: str, version: str) -> dict:
        path = self._path(name, version)
        if not path.exists():
            raise FileNotFoundError(f"{name}:{version}")
        return json.loads(path.read_text())

    def versions(self, name: str) -> list[str]:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid name {name!r}")
        d = self.root / name
        return sorted(p.stem for p in d.glob("*.json")) if d.exists() else []

    def names(self) -> list[str]:
        return sorted(p.name for p in self.root.iterdir() if p.is_dir())

    def delete(self, name: str, version: str) -> bool:
        path = self._path(name, version)
        if not path.exists():
            return False
        path.unlink()
        return True


def make_app(store: ArtifactStore) -> web.Application:
    async def create(request: web.Request) -> web.Response:
        body = await request.json()
        name, version = body.get("name"), body.get("version")
        if not name or not version:
            return web.json_response({"error": "name and version required"}, status=400)
        record = {k: v for k, v in body.items() if k not in ("name", "version")}
        try:
            stored = store.put(name, version, record)
        except FileExistsError:
            return web.json_response({"error": "already exists"}, status=409)
        except ValueError as exc:
            return web.json_response({"error": str(exc)}, status=400)
        logger.info("stored graph artifact %s:%s", name, version)
        return web.json_response(stored, status=201)

    async def list_all(request: web.Request) -> web.Response:
        return web.json_response(
            [{"name": n, "versions": store.versions(n)} for n in store.names()]
        )

    async def list_versions(request: web.Request) -> web.Response:
        name = request.match_info["name"]
        try:
            versions = store.versions(name)
        except ValueError as exc:
            return web.json_response({"error": str(exc)}, status=400)
        if not versions:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({"name": name, "versions": versions})

    async def get_one(request: web.Request) -> web.Response:
        try:
            record = store.get(request.match_info["name"], request.match_info["version"])
        except (FileNotFoundError, ValueError):
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response(record)

    async def delete_one(request: web.Request) -> web.Response:
        try:
            removed = store.delete(request.match_info["name"], request.match_info["version"])
        except ValueError:
            removed = False
        if not removed:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({"deleted": True})

    app = web.Application()
    app.router.add_post("/api/v1/graphs", create)
    app.router.add_get("/api/v1/graphs", list_all)
    app.router.add_get("/api/v1/graphs/{name}", list_versions)
    app.router.add_get("/api/v1/graphs/{name}/{version}", get_one)
    app.router.add_delete("/api/v1/graphs/{name}/{version}", delete_one)
    return app


def main() -> int:
    import argparse
    import asyncio

    from dynamo_tpu_torch.utils.logging import configure_logging

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", default="./graph-store")
    parser.add_argument("--port", type=int, default=8085)
    args = parser.parse_args()
    configure_logging()

    async def amain() -> None:
        runner = web.AppRunner(make_app(ArtifactStore(args.root)))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", args.port)
        await site.start()
        logger.info("api-store on :%d root=%s", args.port, args.root)
        await asyncio.Event().wait()

    asyncio.run(amain())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
