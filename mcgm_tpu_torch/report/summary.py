"""Model size tables (port of ``mcgm_tpu/report/summary.py``).

A model's parameters and buffers in the JAX package's variable tree
(``io.jax_import.to_jax_gan_variables``: its collections, module paths and
leaf names, a Glow's flows in its scanned layout), one row per leaf with
collections and keys in sorted order, as a JAX pytree flattens them, so
both packages' ``summary.md`` rows agree.
"""

from __future__ import annotations

import os

import numpy as np
from torch import nn

from ..io.jax_import import to_jax_gan_variables
from ..utils import makedir_exist_ok


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def param_table(variables: dict) -> tuple[list[tuple[str, tuple, int]], dict]:
    """``([(collection/path, shape, count), ...], {collection: total})`` of
    a JAX-layout variable tree (nested dicts of arrays)."""
    rows, totals = [], {}
    for collection in sorted(variables):
        total = 0
        for path, leaf in _leaves(variables[collection]):
            n = int(np.prod(leaf.shape)) if leaf.shape else 1
            rows.append((f"{collection}/{'/'.join(path)}", tuple(leaf.shape), n))
            total += n
        totals[collection] = total
    return rows, totals


def summarize_model(model: nn.Module, name: str = "model", output_dir: str | None = None) -> str:
    """The markdown table of ``model``'s variables and their totals per
    collection; appended to ``{output_dir}/summary.md`` if ``output_dir``."""
    rows, totals = param_table(to_jax_gan_variables(model))
    lines = [f"# {name}", "", "| parameter | shape | count |", "|---|---|---|"]
    lines += [f"| {pname} | {shape} | {n:,} |" for pname, shape, n in rows]
    lines.append("")
    lines += [f"- **{coll}**: {n:,} params" for coll, n in totals.items()]
    grand = sum(totals.values())
    lines.append(f"- **total**: {grand:,} params ({grand * 4 / (1 << 20):.2f} MB fp32)")
    text = "\n".join(lines)
    if output_dir:
        makedir_exist_ok(output_dir)
        with open(os.path.join(output_dir, "summary.md"), "a") as f:
            f.write(text + "\n\n")
    return text
