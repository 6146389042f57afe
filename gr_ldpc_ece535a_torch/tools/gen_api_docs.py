"""Write docs/api_torch.md from the port's public API docstrings.

    python -m gr_ldpc_ece535a_torch.tools.gen_api_docs

The counterpart of ``tools/gen_api_docs.py`` (which writes the JAX
package's ``docs/api.md``): for each module of ``MODULES`` its first
docstring paragraph, then every name of its ``__all__`` with its signature
and docstring (a class with its public methods' docstrings, a constant
with its value). Regenerate after the API changes.
"""

from __future__ import annotations

import importlib
import inspect
import re
from pathlib import Path

__all__ = ["render", "MODULES", "OUT"]

ROOT = Path(__file__).resolve().parents[2]     # the package's parent
OUT = ROOT / "docs" / "api_torch.md"
MODULES = [
    "gr_ldpc_ece535a_torch.codes",
    "gr_ldpc_ece535a_torch.entry",
    "gr_ldpc_ece535a_torch.ops",
    "gr_ldpc_ece535a_torch.ops.cuda_bp",
    "gr_ldpc_ece535a_torch.ops.cuda_dsp",
    "gr_ldpc_ece535a_torch.ops.cuda_study",
    "gr_ldpc_ece535a_torch.ops.dsp",
    "gr_ldpc_ece535a_torch.ops.oracle",
    "gr_ldpc_ece535a_torch.blocks",
    "gr_ldpc_ece535a_torch.blocks.graphcfg",
    "gr_ldpc_ece535a_torch.parallel",
    "gr_ldpc_ece535a_torch.sim",
    "gr_ldpc_ece535a_torch.runtime",
    "gr_ldpc_ece535a_torch.utils.config",
    "gr_ldpc_ece535a_torch.utils.profiling",
    "gr_ldpc_ece535a_torch.utils.bmp",
    "gr_ldpc_ece535a_torch.tools.anchor",
    "gr_ldpc_ece535a_torch.tools.parity_f64",
    "gr_ldpc_ece535a_torch.tools.twovalid",
    "gr_ldpc_ece535a_torch.tools.pfb_track_check",
    "gr_ldpc_ece535a_torch.tools.dsp_loops_check",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    return inspect.getdoc(obj) or "*(no docstring)*"


def _symbol(out: list[str], name: str, obj) -> None:
    if inspect.isclass(obj):
        out.append(f"### class `{name}{_sig(obj)}`\n")
        out.append(_doc(obj) + "\n")
        for m, fn in vars(obj).items():
            if not m.startswith("_") and callable(fn) and inspect.getdoc(fn):
                out.append(f"**`.{m}{_sig(fn)}`** — {inspect.getdoc(fn)}\n")
    elif callable(obj):
        out.append(f"### `{name}{_sig(obj)}`\n")
        out.append(_doc(obj) + "\n")
    else:
        out.append(f"### `{name}`\n")
        out.append(f"`{type(obj).__name__}` constant: `{obj!r}`"[:400] + "\n")


def render(modules=MODULES) -> str:
    """The markdown reference of ``modules``."""
    out = ["# API reference — gr_ldpc_ece535a_torch", "",
           "Generated by `python -m gr_ldpc_ece535a_torch.tools.gen_api_docs`",
           "from the public (`__all__`) docstrings of the PyTorch / CUDA",
           "port. The JAX package's reference is `docs/api.md`.", ""]
    for modname in modules:
        mod = importlib.import_module(modname)
        out.append(f"\n## `{modname}`\n")
        if mdoc := inspect.getdoc(mod):
            out.append(mdoc.split("\n\n")[0] + "\n")
        for name in getattr(mod, "__all__",
                            [n for n in vars(mod) if not n.startswith("_")]):
            obj = getattr(mod, name)
            if not inspect.ismodule(obj):
                _symbol(out, name, obj)
    # paths inside the checkout are written from its root, and a function's
    # repr without its address, so the text is the same in every run
    return re.sub(r" at 0x[0-9a-f]+>", ">",
                  "\n".join(out).replace(str(ROOT), "<repo>"))


def main() -> None:
    text = render()
    OUT.write_text(text)
    n = sum(1 for line in text.splitlines() if line.startswith("### "))
    print(f"wrote {OUT} ({n} symbols, {len(text.splitlines())} lines)")


if __name__ == "__main__":
    main()
