"""Generate the markdown API reference from the port's stage registry.

Counterpart of ``tools/gen_docs.py``: reflect over every registered
stage of ``mmlspark_tpu_torch`` and write one markdown page per package
with each stage's docstring and parameter table. The port's pages list
the same stages and parameters as the JAX package's, and one parameter
more on the stages that compute on a device: ``device``.

Usage: python -m mmlspark_tpu_torch.tools.gen_docs --out DIR
(it writes only under ``DIR``; the JAX package's pages stay its own)
"""

from __future__ import annotations

import argparse
import collections
import inspect
import os


def param_rows(cls):
    rows = []
    for name, p in cls.params().items():
        default = "—" if p.default is None else repr(p.default)
        rows.append((name, default, (p.doc or "").replace("|", "\\|")))
    return sorted(rows)


def write_docs(out_dir: str) -> dict:
    """Write the pages under ``out_dir``; returns ``{"pages": n,
    "stages": n, "out": out_dir}``."""
    import mmlspark_tpu_torch.all  # noqa: F401  (populate the registry)
    from mmlspark_tpu_torch.core.registry import all_stages, resolve

    by_module = collections.defaultdict(list)
    for qualname in sorted(all_stages()):
        cls = resolve(qualname)
        module = qualname.rsplit(".", 2)[0]  # mmlspark_tpu_torch.<pkg>
        by_module[module].append(cls)

    os.makedirs(out_dir, exist_ok=True)
    index = ["# API reference", "",
             "Generated by `python -m mmlspark_tpu_torch.tools.gen_docs` "
             "from the stage registry —",
             "do not edit by hand.", ""]
    for module, classes in sorted(by_module.items()):
        page = module.split(".", 1)[1].replace(".", "_")
        index.append(f"- [{module}]({page}.md) — {len(classes)} stages")
        lines = [f"# {module}", ""]
        for cls in classes:
            lines.append(f"## {cls.__name__}")
            lines.append("")
            doc = inspect.getdoc(cls) or "(no docstring)"
            lines.append(doc)
            lines.append("")
            rows = param_rows(cls)
            if rows:
                lines.append("| param | default | doc |")
                lines.append("|---|---|---|")
                for name, default, doc_ in rows:
                    lines.append(f"| `{name}` | `{default}` | {doc_} |")
                lines.append("")
        with open(os.path.join(out_dir, f"{page}.md"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    total = sum(len(v) for v in by_module.values())
    return {"pages": len(by_module), "stages": total, "out": out_dir}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory to write the pages into")
    args = ap.parse_args(argv)
    out = write_docs(args.out)
    print(f"wrote {out['pages']} pages, {out['stages']} stages -> "
          f"{out['out']}")
    return out


if __name__ == "__main__":
    main()
