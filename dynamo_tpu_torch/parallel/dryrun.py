"""``dryrun_multichip(n)``: the serving forwards over an n-rank mesh at a tiny
geometry (counterpart of ``dryrun_multichip`` in the reference's
``__graft_entry__.py``).

The n ranks factor into dp x tp as the reference factors its devices (tp
the largest of 4, 2, 1 that divides n and the kv heads).  Each rank is a
process of its own (``python -m dynamo_tpu_torch.parallel.dryrun``) over a
FileStore: it draws the weights from one seed and keeps its tp slice, runs
one prefill (every dp replica alike) and one decode whose batch is split
over dp (each replica its lanes, sampled), and the int8 check: the same
decode with int8 weights quantized on the full matrices and sliced under the
same mesh, its logits within a relative 0.1 of the full-precision ones.
Then the reference's pipeline and sequence sections, each on a mesh of its
own over the same ranks: the ring prefill over every rank (sp = n), its
logits within 2e-3 of the dp/tp prefill's; the pipelined decode at pp = 2 x
tp = n/2, its logits within a relative 2e-3 of one rank's unsharded
decode; and the Mixtral ``tiny_moe`` greedy drive (a prefill a lane, then
15 pipelined decode steps) at pp = 2 x ep = n/2, its tokens equal to the
unsharded drive's.  Rank 0 prints the reference's lines and the tokens
gathered over dp.

On the CPU (``device="cpu"``) the ranks run over gloo; on cards over nccl,
or several ranks to a card where the caller names ``backend="gloo"``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from dynamo_tpu_torch.parallel.mesh import (
    MeshConfig,
    all_gather,
    leaf_sharder,
    make_mesh,
    resolve_backend,
    shard_config,
)

LANES = 4


def factor(n: int, kv_heads: int = 4) -> tuple[int, int]:
    """(dp, tp): tp the largest of 4, 2, 1 dividing both n and the kv
    heads, as the reference factors its devices."""
    tp = next(c for c in (4, 2, 1) if n % c == 0 and kv_heads % c == 0)
    return n // tp, tp


def _rank(rank: int, n: int, init: str, device_type: str, backend: str) -> dict:
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops.random import fold_in, gumbel
    from dynamo_tpu_torch.ops.sampling import sample_tokens

    cfg = llama.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=8,
        num_kv_heads=4, head_dim=16, max_position_embeddings=256, rope_theta=10000.0,
        tie_word_embeddings=True, dtype=torch.float32,
    )
    dp, tp = factor(n, cfg.num_kv_heads)
    mesh = make_mesh(MeshConfig(dp=dp, tp=tp), device_type=device_type, backend=backend,
                     rank=rank, world_size=n, init_method=init)
    dev = mesh.device
    out: dict = {"dp": dp, "tp": tp, "devices": n}

    def weights(quant=()):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return llama.init_params(cfg, gen, dev,
                                 shard=leaf_sharder(llama.param_specs(cfg), mesh, quant))

    params = weights()
    num_blocks, block_size, max_blocks = 32, 4, 8
    cache = llama.init_kv_cache(shard_config(cfg, mesh), num_blocks, block_size, None, dev)
    cos, sin = llama.make_rope_tables(cfg, dev)
    ids = torch.arange(16, device=dev) % 7 + 2
    blocks = torch.arange(max_blocks, dtype=torch.int32, device=dev)
    logits, cache = llama.llama_forward_prefill(params, cfg, ids, cache, blocks, 10, 0, cos, sin,
                                                mesh=mesh)
    out["prefill_shape"] = list(logits.shape)
    prefill_logits = logits

    # the decode batch split over dp: this replica's lanes
    per = LANES // dp
    lanes = torch.arange(mesh.index("dp") * per, (mesh.index("dp") + 1) * per, device=dev)
    tables = blocks[None, :].repeat(per, 1)
    lens = torch.full((per,), 11, dtype=torch.int32, device=dev)
    slots = (lanes + 10).to(torch.int32)
    tokens_in = torch.zeros((per,), dtype=torch.int32, device=dev)

    def decode(p, c):
        return llama.llama_forward_decode(p, cfg, tokens_in, c, tables, lens, slots, cos, sin,
                                          mesh=mesh)[0]

    def copy_of(c):  # a cache of its own (with its dump row), equal to c
        fresh = llama.init_kv_cache(shard_config(cfg, mesh), num_blocks, block_size, None, dev)
        for k in fresh:
            fresh[k].copy_(c[k])
        return fresh

    pristine = copy_of(cache)
    logits = decode(params, cache)
    keys = torch.stack([lanes, torch.full_like(lanes, 2)], dim=1).long()
    noise = gumbel(fold_in(keys, lens.long()), cfg.vocab_size)
    tokens = sample_tokens(
        logits, noise, torch.full((per,), 0.7, device=dev),
        torch.full((per,), 20, dtype=torch.int32, device=dev),
        torch.full((per,), 0.9, device=dev), torch.zeros((per,), dtype=torch.bool, device=dev))
    out["tokens"] = all_gather(tokens, mesh, "dp", dim=0).tolist()

    # weight-only int8 under the same mesh: the quantized logits track the
    # full-precision ones within int8 error
    qparams = weights(llama.QUANT_LEAVES)
    lf = decode(params, copy_of(pristine))
    lq = decode(qparams, copy_of(pristine))
    out["int8_rel_err"] = float((lq - lf).norm() / lf.norm().clamp(min=1e-9))

    # the sequence ring over every rank: the prefill's logits against the
    # dp/tp mesh's
    sp_mesh = make_mesh(MeshConfig(sp=n), device_type=device_type, backend=backend)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    full = llama.init_params(cfg, gen, dev)
    sp_logits, _ = llama.llama_forward_prefill(
        full, cfg, ids, llama.init_kv_cache(cfg, num_blocks, block_size, None, dev), blocks, 10,
        0, cos, sin, mesh=sp_mesh)
    out["sp"] = n
    out["sp_prefill_max_abs_diff"] = float((sp_logits - prefill_logits).abs().max())

    # the pipelined decode over pp = 2 x tp = n / 2 against one rank's
    # unsharded decode, both on a fresh cache
    lanes4 = torch.arange(LANES, device=dev)
    dec_in = (torch.zeros((LANES,), dtype=torch.int32, device=dev),
              blocks[None, :].repeat(LANES, 1),
              torch.full((LANES,), 11, dtype=torch.int32, device=dev),
              (lanes4 + 10).to(torch.int32))
    if n % 2 == 0 and cfg.num_kv_heads % (n // 2) == 0:
        from dynamo_tpu_torch.engine.shard_worker import shard_cache
        from dynamo_tpu_torch.models.registry import get_family

        pp_mesh = make_mesh(MeshConfig(pp=2, tp=n // 2), device_type=device_type,
                            backend=backend)
        fam = get_family("llama")
        gen.manual_seed(0)
        pp_params = llama.init_params(cfg, gen, dev, shard=leaf_sharder(
            fam.mesh_param_specs(cfg, pp_mesh), pp_mesh))
        logits_pp, _ = llama.llama_forward_decode_pp(
            pp_params, cfg, dec_in[0], shard_cache(fam, cfg, pp_mesh, num_blocks, block_size,
                                                   None, dev),
            *dec_in[1:], cos, sin, mesh=pp_mesh)
        logits_ref, _ = llama.llama_forward_decode(
            full, cfg, dec_in[0], llama.init_kv_cache(cfg, num_blocks, block_size, None, dev),
            *dec_in[1:], cos, sin)
        out["pp_tp"] = [2, n // 2]
        if logits_pp is not None:  # stage 0 holds the logits
            out["pp_rel_err"] = float((logits_pp - logits_ref).norm()
                                      / logits_ref.norm().clamp(min=1e-9))
        out["pp_mixtral"] = _pp_ep_drive(n, dev, device_type, backend)
    return out


def _pp_ep_drive(n: int, dev, device_type: str, backend: str) -> dict | None:
    """The reference dryrun's pp x ep Mixtral check: a greedy drive (a
    prefill a lane, then pipelined decode steps feeding each step's argmax
    back, rank 0's tokens broadcast to every rank as the engine's step
    broadcast does) on pp = 2 x ep = n / 2, against the same drive on one
    rank, unsharded.  ``{"tokens_equal": ..., "steps": ...}``; None where
    the experts do not split over n / 2."""
    from dynamo_tpu_torch.engine.shard_worker import shard_cache
    from dynamo_tpu_torch.models import mixtral
    from dynamo_tpu_torch.models.registry import get_family
    from dynamo_tpu_torch.parallel.mesh import broadcast

    mcfg = mixtral.MixtralConfig.tiny_moe()
    if n % 2 or mcfg.num_experts % (n // 2):
        return None
    fam = get_family("mixtral")
    batch, steps, prompt_len, seq_pad, block_size, lane_blocks = 4, 16, 10, 16, 4, 12
    num_blocks = lane_blocks * batch + 2
    prompts = torch.stack([(torch.arange(seq_pad, device=dev) * (i + 3)) % (mcfg.vocab_size - 20)
                           + 10 for i in range(batch)]).to(torch.int32)
    tables = torch.stack([torch.arange(lane_blocks, dtype=torch.int32, device=dev)
                          + i * lane_blocks for i in range(batch)])
    cos, sin = fam.make_rope_tables(mcfg, dev, 256)
    mesh = make_mesh(MeshConfig(pp=2, ep=n // 2), device_type=device_type, backend=backend)

    def drive(params, cache, m) -> list:
        first = []
        for i in range(batch):
            logits, cache = fam.forward_prefill(params, mcfg, prompts[i], cache, tables[i],
                                                prompt_len, 0, cos, sin, mesh=m)
            first.append(int(logits.argmax()) if logits is not None else 0)
        cur = torch.tensor(first, dtype=torch.int32, device=dev)
        if m is not None:
            cur = broadcast(cur, m)
        out = [cur.tolist()]
        lens = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
        lane = torch.arange(batch, device=dev)
        for _ in range(steps - 1):
            slots = (tables[lane, (lens // block_size).long()] * block_size
                     + lens % block_size).to(torch.int32)
            lens = lens + 1
            fwd = fam.forward_decode if m is None else fam.forward_decode_pp
            logits, cache = fwd(params, mcfg, cur, cache, tables, lens, slots, cos, sin, mesh=m)
            cur = (logits.argmax(dim=-1).to(torch.int32) if logits is not None
                   else torch.zeros_like(cur))
            if m is not None:
                cur = broadcast(cur, m)
            out.append(cur.tolist())
        return out

    def weights(shard=None):
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        return mixtral.init_params(mcfg, gen, dev, shard=shard)

    expected = drive(weights(), fam.init_kv_cache(mcfg, num_blocks, block_size, None, dev), None)
    got = drive(weights(leaf_sharder(fam.mesh_param_specs(mcfg, mesh), mesh)),
                shard_cache(fam, mcfg, mesh, num_blocks, block_size, None, dev), mesh)
    return {"pp": 2, "ep": n // 2, "steps": steps, "tokens_equal": got == expected}


def dryrun_multichip(n_devices: int, *, device: str = "cuda", backend: str | None = None,
                     timeout: float = 300.0) -> dict:
    """Run the dryrun on ``n_devices`` rank processes; returns rank 0's
    summary (``dp``, ``tp``, ``prefill_shape``, the sampled ``tokens`` of
    every lane, ``int8_rel_err``) and raises if a rank failed or the int8
    logits strayed."""
    chosen = resolve_backend(MeshConfig(tp=n_devices), device, backend, n_devices)
    tmp = tempfile.mkdtemp(prefix="dyn-dryrun-")
    init, result = f"file://{tmp}/store", os.path.join(tmp, "rank0.json")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.parallel.dryrun", "--rank", str(r),
             "--world-size", str(n_devices), "--init-method", init, "--device", device,
             "--backend", chosen, "--out", result], env=env, stdin=subprocess.DEVNULL)
            for r in range(n_devices)]
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        if any(codes):
            raise RuntimeError(f"dryrun_multichip: rank exit codes {codes}")
        with open(result) as f:
            summary = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if summary["int8_rel_err"] > 0.1:
        raise RuntimeError(f"int8 logits strayed: relative error {summary['int8_rel_err']:.3f}")
    if summary["sp_prefill_max_abs_diff"] > 2e-3:
        raise RuntimeError("sp ring-attention prefill diverged from dp/tp prefill: "
                           f"{summary['sp_prefill_max_abs_diff']}")
    if summary.get("pp_rel_err", 0.0) > 2e-3:
        raise RuntimeError(f"pp x tp decode diverged: rel={summary['pp_rel_err']:.5f}")
    if summary.get("pp_mixtral") and not summary["pp_mixtral"]["tokens_equal"]:
        raise RuntimeError("pp x ep (mixtral) multi-step decode diverged from one rank's")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of dryrun_multichip")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None)
    ap.add_argument("--out", required=True, help="rank 0's summary (JSON)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    import torch.distributed as dist

    out = _rank(args.rank, args.world_size, args.init_method, args.device, args.backend)
    dist.destroy_process_group()
    if args.rank == 0:
        print(f"dryrun mesh: dp={out['dp']} tp={out['tp']} devices={out['devices']}", flush=True)
        print(f"prefill step ok: {tuple(out['prefill_shape'])}", flush=True)
        print(f"decode step ok: {out['tokens']}", flush=True)
        print(f"int8 decode logits: relative error {out['int8_rel_err']:.4f}", flush=True)
        print(f"sp prefill step ok: ring over sp={out['sp']}, logits max |diff| "
              f"{out['sp_prefill_max_abs_diff']:.2e}", flush=True)
        if "pp_rel_err" in out:
            print(f"pp decode step ok: pp={out['pp_tp'][0]}xtp={out['pp_tp'][1]}, rel err "
                  f"{out['pp_rel_err']:.2e}", flush=True)
        if out.get("pp_mixtral"):
            m = out["pp_mixtral"]
            print(f"multi-step parity {'ok' if m['tokens_equal'] else 'FAILED'}: "
                  f"pp={m['pp']}xep={m['ep']} (mixtral) — {m['steps']}x4 tokens", flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
