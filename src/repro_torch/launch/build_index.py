"""Index build launcher of the port: the paper's offline stage as a CLI
(counterpart of ``repro.launch.build_index``).

  python -m repro_torch.launch.build_index --n-proteins 20000 --sections 10 \
      --arity 32 64 --out /tmp/lmi_index [--device cuda]

Generates the synthetic protein dataset (in chunks), embeds it on the
device, builds the K-Means level stack and saves it in the JAX package's
format 2 (docs/index_format.md), which JAX's ``load_index`` reads too.
Flags are the JAX launcher's, over what this slice supports, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions).
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
from repro_torch.index_io import save_index


def parse_arities(args) -> tuple[int, ...]:
    """--arities "64,64,64" (comma string) overrides --arity 64 64 64."""
    if getattr(args, "arities", None):
        return tuple(int(a) for a in str(args.arities).split(","))
    return tuple(int(a) for a in args.arity)


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
                         "(float32 or bfloat16 in the port so far)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda",
                    help="device to embed and build on (default cuda; cpu runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)
    arities = parse_arities(args)
    # fail fast on knobs this slice cannot serve, before generation and fits
    store_lib.validate_dtype(args.store_dtype, flag="--store-dtype")
    store_lib.require_supported(args.store_dtype)
    lmi._require_kmeans(args.model)
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
        st = store_lib.from_lmi(index, args.store_dtype)
        print(f"candidate store ({args.store_dtype}): "
              f"{st.nbytes(include_metadata=False) / 2**20:.1f} MB")

    save_index(args.out, index, n_sections=args.sections, cutoff=args.cutoff, seed=args.seed,
               store_dtype=args.store_dtype, build_seconds=t_build, embed_seconds=t_embed)
    print(f"saved to {args.out}")
    return index


if __name__ == "__main__":
    main()
