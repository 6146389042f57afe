#!/usr/bin/env python3
"""Run a declarative YAML flowgraph (GRC equivalent).

    python -m gr_ldpc_ece535a_torch.apps.ldpc_flowgraph examples/example1.yaml
    python -m gr_ldpc_ece535a_torch.apps.ldpc_flowgraph examples/example6.yaml -p chan.noise_voltage=0.2

The counterpart of ``apps/ldpc_flowgraph.py``, with its flags, except that
the device is named (``--device``, the card by default; no ``--cpu``): it
goes to every block that takes one and whose YAML names none. -p overrides
block parameters: ``-p block.param=value`` (value parsed as YAML, the CLI
analog of moving a GRC slider).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("graph", help="YAML flowgraph path")
    ap.add_argument("-p", "--param", action="append", default=[],
                    metavar="BLOCK.PARAM=VALUE", help="override a block param")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the blocks that take one")
    args = ap.parse_args(argv)

    import yaml

    overrides: dict[str, dict] = {}
    for spec in args.param:
        try:
            target, value = spec.split("=", 1)
            bname, pname = target.split(".", 1)
        except ValueError:
            ap.error(f"bad -p {spec!r}; expected block.param=value")
        overrides.setdefault(bname, {})[pname] = yaml.safe_load(value)

    from gr_ldpc_ece535a_torch.blocks import run_flowgraph

    blocks = run_flowgraph(args.graph, overrides=overrides,
                           device=args.device)
    # post-run report for sink blocks
    for name, b in blocks.items():
        if getattr(b, "images_written", None) is not None:
            print(f"{name}: images_written={b.images_written}")
        if getattr(b, "count", None) is not None:
            print(f"{name}: items={b.count}")


if __name__ == "__main__":
    main()
