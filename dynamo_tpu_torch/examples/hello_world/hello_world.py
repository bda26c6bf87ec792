"""Minimal SDK graph (reference: examples/hello_world; a copy of the
repository's examples/hello_world on the port's SDK).

Three chained services; each stage decorates the text it passes along.

    python -m dynamo_tpu_torch.examples.hello_world.hello_world
"""

from __future__ import annotations

import asyncio

from dynamo_tpu_torch.runtime import Context, DistributedRuntime
from dynamo_tpu_torch.runtime.client import PushRouter
from dynamo_tpu_torch.sdk.graph import deploy_inprocess, depends, endpoint, service
from dynamo_tpu_torch.utils.config import RuntimeConfig


@service()
class Backend:
    @endpoint()
    async def generate(self, request, ctx):
        for word in request["text"].split():
            yield {"word": f"Backend[{word}]"}


@service()
class Middle:
    backend = depends(Backend)

    @endpoint()
    async def generate(self, request, ctx):
        request["text"] = request["text"].upper()
        stream = await self.backend.generate(Context(request, ctx))
        async for item in stream:
            yield {"word": f"Middle({item['word']})"}


@service()
class Frontend:
    middle = depends(Middle)

    @endpoint()
    async def generate(self, request, ctx):
        stream = await self.middle.generate(Context(request, ctx))
        async for item in stream:
            yield item


async def run(text: str = "hello world") -> list[str]:
    rt = await DistributedRuntime.create(RuntimeConfig(control_plane="memory://hello"))
    try:
        handles = await deploy_inprocess(Frontend, rt)
        ep = rt.namespace("dynamo").component("frontend").endpoint("generate")
        router = await PushRouter.from_endpoint(ep)
        await router.client.wait_for_instances(1, timeout=5)
        out = await (await router.generate(Context({"text": text}))).collect()
        words = [o["word"] for o in out]
        for services in handles.values():
            for s in services:
                await s.shutdown(drain_timeout=1)
        return words
    finally:
        await rt.close()


if __name__ == "__main__":
    for word in asyncio.run(run()):
        print(word)
