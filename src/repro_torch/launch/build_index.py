"""Index build launcher of the port: the paper's offline stage as a CLI
(counterpart of ``repro.launch.build_index``).

  python -m repro_torch.launch.build_index --n-proteins 20000 --sections 10 \
      --arity 32 64 --out /tmp/lmi_index [--device cuda]

Generates the synthetic protein dataset (in chunks), embeds it on the
device, builds the K-Means level stack and saves it in the JAX package's
format 2 (docs/index_format.md), which JAX's ``load_index`` reads too.
Flags are the JAX launcher's, over what the port supports, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions).
``--store-dtype`` / ``--scale-granularity`` / ``--compute-dtype`` and
``--beam`` / ``--node-eval`` record the serving defaults in meta.json;
``--prebuilt-planes`` saves the canonical node planes of the segmented
beam beside the index.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import lmi
from repro_torch.core import store as store_lib
from repro_torch.core.embedding import EmbeddingConfig, embed_dataset
from repro_torch.data.proteins import ProteinGenConfig, iter_dataset
from repro_torch.index_io import load_planes, save_index


def parse_arities(args) -> tuple[int, ...]:
    """--arities "64,64,64" (comma string) overrides --arity 64 64 64."""
    if getattr(args, "arities", None):
        return tuple(int(a) for a in str(args.arities).split(","))
    return tuple(int(a) for a in args.arity)


def parse_beam(value):
    """--beam forms (build_index and serve share this parser): None
    (unset), "0" (force exact), "128" (scalar width), or a comma schedule
    "64,16" (one width per pruned level). -> None | int | tuple."""
    if value is None:
        return None
    vals = [int(p) for p in str(value).split(",") if p.strip() != ""]
    if not vals:
        return None
    if len(vals) == 1:
        return None if vals[0] <= 0 else vals[0]
    return tuple(vals)


def parse_temperatures(value):
    """--temperatures comma floats ("1.0,0.7,0.5", one per level) -> tuple,
    or None when unset."""
    if value is None:
        return None
    vals = [float(p) for p in str(value).split(",") if p.strip() != ""]
    return tuple(vals) or None


def generate_embeddings(seed: int, gen_cfg: ProteinGenConfig, emb_cfg: EmbeddingConfig,
                        device, chunk_size: int = 65536):
    """Generate and embed the dataset chunk by chunk -> ((M, dim) tensor on
    ``device``, generate seconds, embed seconds)."""
    t_gen = t_emb = 0.0
    outs = []
    it = iter_dataset(seed, gen_cfg, chunk_size=chunk_size)
    while True:
        t0 = time.perf_counter()
        chunk = next(it, None)
        t_gen += time.perf_counter() - t0
        if chunk is None:
            break
        t0 = time.perf_counter()
        outs.append(embed_dataset(chunk.coords, chunk.lengths, emb_cfg, device=device))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t_emb += time.perf_counter() - t0
    return torch.cat(outs, dim=0), t_gen, t_emb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-proteins", type=int, default=20_000)
    ap.add_argument("--n-families", type=int, default=200)
    ap.add_argument("--sections", type=int, default=10)
    ap.add_argument("--cutoff", type=float, default=50.0)
    ap.add_argument("--arity", type=int, nargs="+", default=(32, 64),
                    help="per-level arities, e.g. --arity 256 64 or --arity 64 64 64")
    ap.add_argument("--arities", type=str, default=None,
                    help="comma form of --arity, e.g. --arities 64,64,64 (overrides it)")
    ap.add_argument("--model", choices=lmi.MODEL_TYPES, default="kmeans",
                    help="node model family (only kmeans builds in the port so far)")
    ap.add_argument("--store-dtype", type=str, default="float32",
                    help="serving-time candidate-store precision recorded in meta.json "
                         f"(one of {', '.join(store_lib.STORE_DTYPES)}; the store is "
                         "re-materialized from the f32 CSR arrays at load)")
    ap.add_argument("--scale-granularity", type=str, default="row",
                    help="quantization scale granularity recorded in meta.json: 'row' "
                         "(one absmax scale per CSR row) or 'bucket' (one per CSR bucket, "
                         "delivered per run to the filter kernel)")
    ap.add_argument("--compute-dtype", choices=("float32", "int8"), default="float32",
                    help="serving-time filter contraction domain recorded in meta.json "
                         "('int8' = the integer-domain path for int8 stores; other "
                         "stores run float32)")
    ap.add_argument("--beam", type=str, default=None,
                    help="default serving beam recorded in meta.json: a scalar width, "
                         "a comma schedule '64,16' (one width per pruned level), or 0 "
                         "for exact leaf enumeration (None = exact)")
    ap.add_argument("--node-eval", choices=lmi.NODE_EVAL_MODES, default="gather",
                    help="default beam node-evaluation mode recorded in meta.json "
                         "('segmented' runs the beam_eval kernel on CUDA)")
    ap.add_argument("--prebuilt-planes", action="store_true",
                    help="materialize the canonical node planes of the segmented beam "
                         "once and save them next to the index (keyed on index "
                         "revision + temperature schedule)")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit per-level temperatures + a beam width schedule (not "
                         "ported yet: raises)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda",
                    help="device to embed and build on (default cuda; cpu runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    arities = parse_arities(args)
    # fail fast on knobs this slice cannot serve, before generation and fits
    store_lib.validate_dtype(args.store_dtype, flag="--store-dtype")
    store_lib.validate_granularity(args.scale_granularity)
    lmi._require_kmeans(args.model)
    if args.calibrate:
        raise NotImplementedError(
            "--calibrate is not ported yet (ROADMAP 'Next': gmm / logreg fits and "
            "calibration); record a schedule with --beam instead")
    beam = parse_beam(args.beam)
    lmi.normalize_beam_widths(beam, len(arities))  # a bad schedule fails before the build
    device = resolve_device(args.device)

    ecfg = EmbeddingConfig(n_sections=args.sections, cutoff=args.cutoff)
    emb, t_gen, t_embed = generate_embeddings(
        args.seed, ProteinGenConfig(n_proteins=args.n_proteins, n_families=args.n_families),
        ecfg, device)
    print(f"dataset: {args.n_proteins} chains in {t_gen:.1f}s")
    print(f"embedded -> ({emb.shape[0]}, {emb.shape[1]}) in {t_embed:.1f}s "
          f"({emb.numel() * 4 / 2**20:.1f} MB) on {device}")

    t0 = time.perf_counter()
    index = lmi.build(args.seed, emb, arities=arities, model_type=args.model, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_build = time.perf_counter() - t0
    sizes = index.bucket_sizes().cpu().numpy()
    print(f"LMI {'x'.join(map(str, arities))} ({args.model}, depth {index.depth}) "
          f"built in {t_build:.1f}s; "
          f"buckets: mean={sizes.mean():.1f} max={sizes.max()} empty={(sizes == 0).sum()}")
    print(f"index structure: {index.memory_bytes() / 2**20:.1f} MB "
          f"(+data: {index.memory_bytes(include_data=True) / 2**20:.1f} MB)")
    if args.store_dtype != "float32":
        st = store_lib.from_lmi(index, args.store_dtype,
                                scale_granularity=args.scale_granularity)
        f32_bytes = index.sorted_embeddings.numel() * 4
        print(f"candidate store ({args.store_dtype}, {args.scale_granularity} scales): "
              f"{st.nbytes(include_metadata=False) / 2**20:.1f} MB "
              f"({f32_bytes / max(st.nbytes(include_metadata=False), 1):.1f}x smaller than f32)")

    save_index(args.out, index, n_sections=args.sections, cutoff=args.cutoff, seed=args.seed,
               store_dtype=args.store_dtype,
               beam_width=beam if isinstance(beam, int) else None,
               beam_widths=beam if isinstance(beam, tuple) else None,
               node_eval=args.node_eval, prebuilt_planes=args.prebuilt_planes,
               scale_granularity=args.scale_granularity, compute_dtype=args.compute_dtype,
               build_seconds=t_build, embed_seconds=t_embed)
    if args.prebuilt_planes:
        planes = load_planes(args.out, index)
        print(f"prebuilt planes: {planes.nbytes() / 2**20:.1f} MB "
              f"(revision {planes.revision}, {len(planes.levels)} pruned levels)")
    print(f"saved to {args.out}")
    return index


if __name__ == "__main__":
    main()
