"""TUM rgb/depth timestamp association (copy of revo_tpu/io/associate.py).

Real TUM RGB-D downloads ship ``rgb.txt`` and ``depth.txt`` (not
``associate.txt``); the benchmark's external ``associate.py`` pairs them by
nearest timestamp.  The reference assumes the user ran that script
(README.md:43-57); here it is in-repo with the same semantics: greedy
best-match within ``max_difference`` seconds (TUM default 0.02).
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple


def read_file_list(path: str) -> Dict[float, str]:
    """Parse a TUM 'timestamp filename' list file ('#' comments skipped)."""
    out: Dict[float, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                out[float(parts[0])] = parts[1]
    return out


def associate(
    first: Dict[float, str],
    second: Dict[float, str],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[float, float]]:
    """Greedy nearest-timestamp matching, identical to TUM associate.py:
    all candidate pairs within max_difference sorted by |dt|, consumed
    greedily."""
    first_keys = set(first.keys())
    second_keys = set(second.keys())
    candidates = sorted(
        (abs(a - (b + offset)), a, b)
        for a in first_keys
        for b in second_keys
        if abs(a - (b + offset)) < max_difference
    )
    matches = []
    for _, a, b in candidates:
        if a in first_keys and b in second_keys:
            first_keys.remove(a)
            second_keys.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def write_associations(
    dataset_dir: str,
    rgb_list: str = "rgb.txt",
    depth_list: str = "depth.txt",
    out_file: str = "associate.txt",
    max_difference: float = 0.02,
) -> int:
    """Generate associate.txt ('rgbTs rgbPath depthTs depthPath' per line,
    the format iowrapperRGBD.cpp:316-317 parses).  Returns the pair count."""
    rgb = read_file_list(os.path.join(dataset_dir, rgb_list))
    depth = read_file_list(os.path.join(dataset_dir, depth_list))
    matches = associate(rgb, depth, max_difference=max_difference)
    with open(os.path.join(dataset_dir, out_file), "w") as f:
        for a, b in matches:
            f.write(f"{a:.6f} {rgb[a]} {b:.6f} {depth[b]}\n")
    return len(matches)
