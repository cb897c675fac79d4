"""Merge the analytic HBM model into LM dry-run records.

The JAX package re-traces each cell (XLA's cost analysis counts a
``while`` body once) and walks the jaxpr for exact logical FLOPs.  The
port's planning run already counts every loop (``launch/steps.py::
lower_cell`` runs the step under the counter) and ``launch/dryrun.py``
writes those counts into each record under the reference's
``jaxpr_*_total`` keys, so this pass re-plans nothing: it replaces the
records' unfused-byte estimate with the analytic HBM model of a fused
step (:func:`analytic_memory_bytes`, the reference's) and prices the
counts.  Terms as the reference's (TPU v5e, elementwise FLOPs at a
sixteenth of the peak), and the H100's under ``h100`` (matmul FLOPs at
the bf16 tensor-core peak, the rest at the f32 CUDA-core peak).

  PYTHONPATH=src python -m repro_torch.roofline.recost --art build/dryrun_lm
"""

import argparse
import json
import pathlib

from repro_torch.configs.registry import get_arch, get_shape, smoke_config
from repro_torch.models.model import build_plan
from repro_torch.roofline import analysis as RA


def analytic_memory_bytes(cfg, shape) -> float:
    """HBM traffic model per device per step (post-fusion), the
    reference's:

      train:  optimizer state sweep (p,g,m,v: 7 fp32 passes) + params
              read fwd+bwd+recompute (3 bf16 passes) + activation
              residual/IO traffic (~12 bf16 passes of the token stream
              per layer: fwd write+read, remat re-write, bwd read, plus
              attention/MLP block IO)
      prefill: params 1 bf16 pass + KV-cache write + ~6 activation passes
      decode:  params 1 pass + KV-cache read at the active length
    """
    n_total = cfg.params_total()
    n_active = cfg.params_active()
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    d = cfg.d_model
    L = cfg.num_layers + cfg.encoder_layers

    if shape.kind == "train":
        opt_sweep = 7 * 4 * n_total
        param_passes = 3 * 2 * n_active
        act = 12 * 2 * tokens * d * L
        return opt_sweep + param_passes + act

    if shape.kind == "prefill":
        cache = 2 * 2 * tokens * cfg.num_kv_heads * cfg.head_dim * L \
            if cfg.num_heads else 0
        act = 6 * 2 * tokens * d * L
        return 2 * n_active + cache + act

    # decode: dominated by reading the KV cache / SSM state per token
    cache_read = 0.0
    for seg in build_plan(cfg):
        cnt = 1 if seg.kind == "shared_attn" else seg.count
        if seg.kind in ("attn", "moe", "shared_attn", "xattn"):
            wlen = min(seg.window, shape.seq_len) if seg.window > 0 \
                else shape.seq_len
            cache_read += (2 * 2 * wlen * cfg.num_kv_heads * cfg.head_dim
                           * cnt * shape.global_batch)
            if seg.kind == "xattn":
                cache_read += (2 * 2 * cfg.encoder_seq * cfg.num_kv_heads
                               * cfg.head_dim * cnt * shape.global_batch)
        elif seg.kind == "mamba":
            state = (cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state * 4
                     + (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
                     * (cfg.ssm_conv - 1) * 2)
            cache_read += 2 * state * cnt * shape.global_batch
    return 2 * n_active + cache_read


def update_artifact(path: pathlib.Path, cfg=None):
    """Recost one record in place (an ``ok`` LM record; graph records and
    failed cells are left as they are).  Returns the new record or
    None."""
    rec = json.loads(path.read_text())
    if rec.get("status") != "ok" or rec.get("arch", "").startswith("graph-"):
        return None
    cfg = cfg or get_arch(rec["arch"])
    shape = get_shape(rec["shape"])
    mm = rec["jaxpr_matmul_flops_total"]
    ew = rec["jaxpr_elementwise_flops_total"]
    dev = rec["devices"]
    mem_bytes = analytic_memory_bytes(cfg, shape)
    rec["analytic_hbm_bytes_total"] = mem_bytes
    rec["flops_per_device"] = (mm + ew) / dev
    rec["bytes_per_device"] = mem_bytes / dev
    rec["compute_s"] = mm / dev / RA.PEAK_FLOPS_BF16 \
        + ew / dev / (RA.PEAK_FLOPS_BF16 / 16)  # VPU
    rec["memory_s"] = mem_bytes / dev / RA.HBM_BW
    rec["collective_s"] = rec["collective_wire_bytes"] / RA.ICI_LINK_BW
    terms = {"compute": rec["compute_s"], "memory": rec["memory_s"],
             "collective": rec["collective_s"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["useful_flops_ratio"] = (
        rec["model_flops_total"] / max(mm, 1.0))
    h = {"compute_s": mm / dev / RA.H100_PEAK_FLOPS_BF16
         + ew / dev / RA.H100_PEAK_FLOPS_F32,
         "memory_s": mem_bytes / dev / RA.H100_HBM_BW,
         "collective_s": rec["collective_wire_bytes"] / RA.H100_NVLINK_BW}
    rec["h100"].update(h, bottleneck=max(h, key=h.get)[:-len("_s")])
    path.write_text(json.dumps(rec, indent=2))
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--art", default="artifacts/dryrun")
    ap.add_argument("--only", default=None, help="substring filter")
    ap.add_argument("--smoke", action="store_true",
                    help="the records are of the reduced configs")
    args = ap.parse_args()
    for path in sorted(pathlib.Path(args.art).glob("*.json")):
        if args.only and args.only not in path.name:
            continue
        cfg = None
        if args.smoke and not path.name.startswith("graph-"):
            cfg = smoke_config(path.name.split("__")[0])
        try:
            rec = update_artifact(path, cfg)
        except Exception as e:  # noqa: BLE001 - report and continue
            print(f"{path.stem}: RECOST FAILED {e!r}")
            continue
        if rec:
            h = rec["h100"]
            print(f"{path.stem:55s} c={rec['compute_s']*1e3:9.2f}ms "
                  f"m={rec['memory_s']*1e3:9.2f}ms "
                  f"x={rec['collective_s']*1e3:9.2f}ms "
                  f"-> {rec['bottleneck']:10s} "
                  f"useful={rec['useful_flops_ratio']:.2f} | H100 "
                  f"c={h['compute_s']*1e3:.2f}ms "
                  f"m={h['memory_s']*1e3:.2f}ms -> {h['bottleneck']}")


if __name__ == "__main__":
    main()
