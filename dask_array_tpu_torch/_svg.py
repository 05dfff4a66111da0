"""Chunk-grid SVG and the Array's HTML card.

Port of ``dask_array_tpu/_svg.py``; the card's backend line names PyTorch
and the configured device.
"""

from __future__ import annotations

import math

import numpy as np

from dask_array_tpu_torch import config


def _grid_lines(size_px, chunks, max_lines=64):
    total = sum(chunks)
    if total == 0 or any(isinstance(c, float) and math.isnan(c) for c in chunks):
        return [0, size_px], True
    pos = [0]
    acc = 0
    for c in chunks:
        acc += c
        pos.append(acc / total * size_px)
    if len(pos) > max_lines:
        step = len(pos) // max_lines + 1
        pos = pos[::step] + [pos[-1]]
    return pos, False


def svg_2d(chunks, size=160):
    """An SVG drawing of a 2-D chunk grid."""
    ys, _ = _grid_lines(size, chunks[0])
    xs, _ = _grid_lines(size, chunks[1])
    h, w = size, size
    lines = [
        f'<svg width="{w + 20}" height="{h + 20}" style="background:#fff">',
        f'<rect x="10" y="10" width="{w}" height="{h}" fill="#ECB172" '
        'fill-opacity="0.6" stroke="#8F4F0B"/>',
    ]
    for y in ys:
        lines.append(
            f'<line x1="10" y1="{10 + y:.1f}" x2="{10 + w}" y2="{10 + y:.1f}" '
            'stroke="#8F4F0B" stroke-width="0.8"/>'
        )
    for x in xs:
        lines.append(
            f'<line x1="{10 + x:.1f}" y1="10" x2="{10 + x:.1f}" y2="{10 + h}" '
            'stroke="#8F4F0B" stroke-width="0.8"/>'
        )
    lines.append("</svg>")
    return "\n".join(lines)


def svg_1d(chunks, size=160):
    xs, _ = _grid_lines(size, chunks[0])
    h = 26
    lines = [
        f'<svg width="{size + 20}" height="{h + 20}" style="background:#fff">',
        f'<rect x="10" y="10" width="{size}" height="{h}" fill="#ECB172" '
        'fill-opacity="0.6" stroke="#8F4F0B"/>',
    ]
    for x in xs:
        lines.append(
            f'<line x1="{10 + x:.1f}" y1="10" x2="{10 + x:.1f}" y2="{10 + h}" '
            'stroke="#8F4F0B" stroke-width="0.8"/>'
        )
    lines.append("</svg>")
    return "\n".join(lines)


def array_svg(chunks):
    if len(chunks) == 1:
        return svg_1d(chunks)
    if len(chunks) == 2:
        return svg_2d(chunks)
    # >2d: draw the trailing two dims
    return svg_2d(chunks[-2:])


def repr_html(array) -> str:
    nbytes = array.nbytes
    nbytes_s = "unknown" if isinstance(nbytes, float) and math.isnan(nbytes) else _fmt(nbytes)
    cbytes = (
        int(np.prod([max(c) for c in array.chunks]) * array.dtype.itemsize)
        if array.ndim and not any(isinstance(c[0], float) and math.isnan(c[0]) for c in array.chunks)
        else None
    )
    rows = [
        ("Bytes", nbytes_s),
        ("Shape", str(array.shape)),
        ("Chunk shape", str(array.chunksize)),
        ("Chunk bytes", _fmt(cbytes) if cbytes else "unknown"),
        ("Count", f"{array.npartitions} blocks"),
        ("dtype", str(array.dtype)),
        ("Backend", f"PyTorch ({config.get('device', 'cuda')})"),
    ]
    table = "".join(
        f"<tr><th style='text-align:left'>{k}</th><td>{v}</td></tr>" for k, v in rows
    )
    svg = array_svg(array.chunks) if array.ndim else ""
    return (
        "<table style='border:0'><tr>"
        f"<td><table>{table}</table></td>"
        f"<td>{svg}</td>"
        "</tr></table>"
    )


def _fmt(n):
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.2f} PiB"
