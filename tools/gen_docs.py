"""Generate API reference docs from the package docstrings.

The reference builds Doxygen HTML from its single header
(/root/reference/docs/config.in); the equivalent here is a markdown API
reference generated from the live module, one section per public symbol
group, written to docs/API.md.

    python tools/gen_docs.py [--out docs/API.md]
"""
from __future__ import annotations

import argparse
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


SECTIONS = [
    ("Spatial containers", ["Grid", "Points", "Point", "KDTree"]),
    ("Structure functions", [
        "StructureFunction", "BarnesStructure", "CressmanStructure",
        "SoarStructure", "ToarStructure", "PowerlawStructure",
        "LinearStructure", "MultipleStructure", "CrossValidation"]),
    ("Transforms", ["Transform", "Identity", "Log", "BoxCox",
                    "StartedBoxCox", "Gamma"]),
    ("Downscaling", ["downscaling", "nearest", "bilinear",
                     "simple_gradient", "full_gradient",
                     "full_gradient_debug", "calc_gradient",
                     "downscale_probability",
                     "mask_threshold_downscale_consensus",
                     "mask_threshold_downscale_quantile", "smart"]),
    ("Neighbourhood statistics", [
        "neighbourhood", "neighbourhood_brute_force",
        "neighbourhood_quantile", "neighbourhood_quantile_fast",
        "get_neighbourhood_thresholds", "neighbourhood_search", "window",
        "neighbourhood_score"]),
    ("Calibration", ["apply_curve", "monotonize_curve",
                     "quantile_mapping_curve", "metric_optimizer_curve",
                     "get_optimal_threshold", "calc_score",
                     "calc_even_quantiles"]),
    ("Data assimilation (OI)", [
        "optimal_interpolation", "optimal_interpolation_full",
        "optimal_interpolation_ensi", "optimal_interpolation_ensi_lr",
        "optimal_interpolation_ensi_ebe",
        "optimal_interpolation_ensi_ebesc",
        "optimal_interpolation_ensi_utem",
        "local_distribution_correction", "staticcorr_points"]),
    ("Gridding / fill / doping", [
        "gridding", "gridding_nearest", "count", "distance", "fill",
        "fill_missing", "doping_square", "doping_circle"]),
    ("Meteorological diagnostics", [
        "dewpoint", "relative_humidity", "wetbulb", "pressure",
        "sea_level_pressure", "qnh", "wind_speed", "wind_direction",
        "gamma_inv"]),
    ("Utilities", ["calc_statistic", "calc_quantile", "interpolate",
                   "get_lower_index", "get_upper_index", "is_valid",
                   "version", "set_omp_threads", "get_omp_threads",
                   "set_debug_level", "get_debug_level"]),
    ("Serving pipelines (device-resident additions)", [
        "Pipeline", "EnsiPipeline"]),
]


def describe(name, obj):
    doc = inspect.getdoc(obj) or "(no docstring)"
    try:
        if inspect.isclass(obj):
            sig = f"class {name}"
            init = inspect.signature(obj.__init__)
            params = [str(p) for p in init.parameters.values()
                      if p.name != "self"]
            sig += f"({', '.join(params)})"
        else:
            sig = f"{name}{inspect.signature(obj)}"
    except (TypeError, ValueError):
        sig = name
    return sig, doc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "API.md"))
    args = ap.parse_args()

    import gridpp_tpu as gridpp

    lines = [
        "# gridpp_tpu API reference",
        "",
        f"Generated by tools/gen_docs.py from gridpp_tpu "
        f"{gridpp.version()} docstrings. The surface mirrors the",
        "reference gridpp Python bindings (include/gridpp.h) one to one;",
        "docstrings cite the reference implementation file:line they",
        "reproduce.",
        "",
    ]
    documented = set()
    for title, names in SECTIONS:
        lines.append(f"## {title}")
        lines.append("")
        for name in names:
            obj = getattr(gridpp, name, None)
            if obj is None:
                continue
            documented.add(name)
            sig, doc = describe(name, obj)
            lines.append(f"### `{sig}`")
            lines.append("")
            lines.append(doc)
            lines.append("")

    # anything public and callable not covered above
    rest = []
    for name in sorted(dir(gridpp)):
        if name.startswith("_") or name in documented:
            continue
        obj = getattr(gridpp, name)
        if callable(obj) and not inspect.ismodule(obj):
            rest.append(name)
    if rest:
        lines.append("## Other public functions")
        lines.append("")
        for name in rest:
            sig, doc = describe(name, getattr(gridpp, name))
            lines.append(f"### `{sig}`")
            lines.append("")
            lines.append(doc)
            lines.append("")

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}: {len(lines)} lines, "
          f"{len(documented) + len(rest)} symbols")


if __name__ == "__main__":
    main()
