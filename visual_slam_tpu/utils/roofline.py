"""Hand-counted per-stage flops/bytes for the tracking hot path, and the
peak rates they are divided by.

Every numerator here is derived from the actual op shapes and defended in
a comment next to its term; per-stage device times (bench.py) divide into
them.

Conventions: a fused multiply-add counts as 2 flops; a compare/max counts
as 1. "bytes" is the stage's traffic ASSUMING its operands and results
round-trip device memory — operands read once, results written once. When
a stage is measured FASTER than that model allows (implied GB/s > the
physical peak), the assumption is disproven by the measurement itself: XLA
fused the stage with its neighbours and the modeled arrays never reached
device memory. stage_table detects this, marks the row
`hbm_roundtrip: false`, drops the (meaningless) bandwidth percentage, and
classifies the stage's bound by compute only — no row may report >100% of
a physical peak.
"""
from __future__ import annotations

# Published peaks per device, keyed by jax's `device_kind`. Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM5 part, dense (no sparsity), at the
# full 700 W power limit: 989 TFLOP/s bf16 tensor, 67 TFLOP/s float32
# outside the tensor cores (the bound used for every float32 stage),
# 3.35 TB/s HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_tflops=989.0, f32_tflops=67.0, hbm_gbps=3350.0),
}


def peaks_for(device_kind: str) -> dict:
    """Peak table row for a device; an unknown device is an error, never a
    default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add its "
            "data-sheet numbers to utils/roofline.PEAKS"
        ) from None


def stage_costs(
    H: int = 480,
    W: int = 640,
    K: int = 1024,   # feature budget (frontend.max_features)
    M: int = 2048,   # tracking-snapshot capacity (map.track_capacity)
    B: int = 32,     # descriptor rotation bins (descriptor_mxu.N_BINS)
    D: int = 256,    # descriptor bits
    PATCH: int = 32,
    nms_radius: int = 3,
    blur_radius: int = 4,
    gn_iters: int = 10,
) -> dict:
    """Per-stage dicts: {flops, flops_dtype, bytes, note}."""
    px = H * W
    s = {}

    # -- detect_blur (ops/detect.corner_peaks_and_blur stencils) --
    # Per pixel: Sobel ix,iy (5 add + 1 mul each = 12); 3 gradient products;
    # 3 separable 3x3 box sums (4 adds each) + 3 scale muls = 15; min-eig
    # response ~8 (incl. sqrt); border mask 1; separable NMS radius r =
    # 2*(2r) maxes + 1 compare = 13 at r=3; separable Gaussian blur radius 4
    # = 2*(1 + 4*3) = 26.  Total ~78 flops/px.
    nms = 4 * nms_radius + 1
    blur = 2 * (1 + blur_radius * 3)
    per_px = 12 + 3 + 15 + 8 + 1 + nms + blur
    s["detect_blur"] = dict(
        flops=per_px * px, flops_dtype="f32",
        bytes=4 * px + 2 * 4 * px,  # image in, peaks + blurred out
        note=f"{per_px} flops/px x {px} px; 1 read + 2 writes",
    )

    # -- top-k corner select (XLA lax.top_k over H*W) --
    # Counted as one comparison sweep of the peak map (the lowering is a
    # multi-pass partial sort; this is the single-pass lower bound).
    s["topk"] = dict(
        flops=px, flops_dtype="f32",
        bytes=4 * px + K * 8,
        note="1 compare/px lower bound; peak map read, K (uv,score) out",
    )

    # -- patch slices (descriptor_mxu.extract_patches: a K x 32 x 32 gather) --
    s["patches"] = dict(
        flops=0, flops_dtype="-",
        bytes=2 * K * PATCH * PATCH * 4,
        note="pure copy: K patches read from the blurred image + written",
    )

    # -- orientation moments (descriptor_mxu.orientation_from_patches) --
    s["orientation"] = dict(
        flops=2 * 2 * K * PATCH * PATCH, flops_dtype="f32",
        bytes=K * PATCH * PATCH * 4,
        note="two K x 1024 matvecs (m10, m01)",
    )

    # -- descriptor sampling (descriptor_mxu._sample_and_pack) --
    # All-bin difference matmul kp,bpd->bkd: 2*K*PATCH^2*D*B in bf16, then
    # the f32 one-hot bin blend bkd,kb->kd: 2*B*K*D.
    samp = 2 * K * PATCH * PATCH * D * B
    s["descriptor"] = dict(
        flops=samp + 2 * B * K * D, flops_dtype="bf16",
        bytes=(
            K * PATCH * PATCH * 2        # flat patches (bf16)
            + B * PATCH * PATCH * D * 2  # difference matrices (bf16)
            + 2 * B * K * D * 4          # (B,K,D) f32 intermediate w+r
            + K * 8 * 4                  # packed descriptors out
        ),
        note=f"2*{K}*{PATCH**2}*{D}*{B} bf16 MACs; the (B,K,D) "
        "intermediate round-trips HBM",
    )

    # -- matching (ops/match.match_ratio_test) --
    # +/-1 Gram matmul 2*M*K*D bf16; top-2 + mutual check ~3 compares/cell.
    s["match"] = dict(
        flops=2 * M * K * D + 3 * M * K, flops_dtype="bf16",
        bytes=(M + K) * D // 8 + (M + K) * D * 2 + M * K * 4,
        note="Hamming-as-matmul (M x 256)(256 x K); distance matrix "
        "written once for top-2/mutual passes",
    )

    # -- PnP fast path (ops/pnp.solve_pnp_tracked, prior-seeded branch) --
    # 3 residual sweeps (project + gate, ~20 flops/pt) + 2 GN calls x
    # gn_iters x ~120 flops/pt (27 upper-H products + J rows + residual).
    s["pnp"] = dict(
        flops=3 * 20 * M + 2 * gn_iters * 120 * M, flops_dtype="f32",
        bytes=M * (3 + 2 + 1) * 4 * 3,
        note="residual sweeps + 2 Huber-IRLS GN refines (RANSAC branch "
        "excluded: lax.cond, not taken with a frame-rate prior)",
    )

    total_flops = sum(v["flops"] for v in s.values())
    total_bytes = sum(v["bytes"] for v in s.values())
    s["_total"] = dict(flops=total_flops, bytes=total_bytes)
    return s


def stage_table(costs: dict, measured_ms: dict | None = None,
                device_kind: str | None = None) -> dict:
    """Roofline table: per-stage flops/bytes (+ achieved rates and % of
    the device's published peaks when measured times are supplied).

    measured_ms keys must match stage_costs keys; stages without a
    measurement get rates of None. `device_kind` selects the peak row
    (required when measured_ms is given).
    """
    peaks = peaks_for(device_kind) if measured_ms else None
    table = {}
    for k, v in costs.items():
        if k.startswith("_"):
            continue
        row = dict(
            gflops=round(v["flops"] / 1e9, 4),
            mbytes=round(v["bytes"] / 1e6, 2),
            dtype=v["flops_dtype"],
            note=v["note"],
        )
        ms = (measured_ms or {}).get(k)
        if ms:
            peak = peaks["bf16_tflops" if v["flops_dtype"] == "bf16" else "f32_tflops"]
            row["ms"] = round(ms, 4)
            pct_compute = v["flops"] / ms / 1e9 / peak * 100
            implied_gbps = v["bytes"] / ms / 1e6
            pct_hbm = implied_gbps / peaks["hbm_gbps"] * 100
            # Physics check: implied bandwidth above the HBM peak means the
            # modeled round-trip did not happen — the stage fused and its
            # arrays stayed on chip. The byte model then says nothing about
            # this stage's bound; classify by compute alone. Same guard on
            # compute: >100% of the compute peak would mean the flop count is
            # overcounted — the row is flagged and NO number derived from
            # the disavowed model (achieved rate, percentage, bound) is
            # printed; no row may state an impossibility.
            row["hbm_roundtrip"] = implied_gbps <= peaks["hbm_gbps"]
            if row["hbm_roundtrip"]:
                row["achieved_gbps"] = round(implied_gbps, 1)
                row["pct_hbm_peak"] = round(pct_hbm, 2)
            else:
                row["achieved_gbps"] = None
                row["pct_hbm_peak"] = None
            flops_ok = pct_compute <= 100.0
            if flops_ok:
                row["achieved_tflops"] = round(v["flops"] / ms / 1e9, 3)
                row["pct_compute_peak"] = round(pct_compute, 2)
            else:
                row["achieved_tflops"] = None
                row["pct_compute_peak"] = None
                row["flop_model_overcounts"] = True
            if not flops_ok:
                row["bound"] = "unknown (flop model overcounts this stage)"
            elif not row["hbm_roundtrip"]:
                row["bound"] = "compute (fused: modeled bytes stayed on chip)"
            elif pct_compute >= pct_hbm:
                row["bound"] = "compute"
            else:
                row["bound"] = "bandwidth"
        table[k] = row
    return table
