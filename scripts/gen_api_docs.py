"""Generate per-module API reference pages (docs/reference/*.md) from
the package's numpydoc docstrings — the markdown-book analogue of the
reference's Sphinx autosummary pages
(/root/reference/docs/source/{devices,types,ook,ppm,utils,lab}.rst).

Usage: python scripts/gen_api_docs.py      (writes docs/reference/)

Deterministic output (sorted members, no timestamps) so the generated
pages are committed and diffs stay meaningful.
"""
import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "docs", "reference")

# module -> (page title, reference counterpart)
MODULES = {
    "opticomlib_tpu.params": ("Simulation parameters (gv / SimParams)",
                              "typing.py:106-388 (global_variables)"),
    "opticomlib_tpu.signals": ("Signal types",
                               "typing.py:402-2427"),
    "opticomlib_tpu.devices": ("Device library",
                               "devices.py"),
    "opticomlib_tpu.link": ("Fused link programs", "no counterpart "
                            "(new capability; staged chain: examples/)"),
    "opticomlib_tpu.link_sharded": ("Sharded fused link",
                                    "no counterpart (new capability)"),
    "opticomlib_tpu.link_pipeline": ("Pipelined fused link",
                                     "no counterpart (new capability)"),
    "opticomlib_tpu.models.ook": ("OOK modulation stack", "ook.py"),
    "opticomlib_tpu.models.ppm": ("PPM modulation stack", "ppm.py"),
    "opticomlib_tpu.eyediag": ("Eye diagrams", "typing.py:2469-2809"),
    "opticomlib_tpu.lab": ("Lab / instrument layer", "lab.py"),
    "opticomlib_tpu.utils.analysis": ("Numeric & analysis utilities",
                                      "utils.py"),
    "opticomlib_tpu.utils.theory": ("Analytic BER / noise theory",
                                    "utils.py:1288-1493"),
    "opticomlib_tpu.ops.ssfm": ("SSFM propagation engine",
                                "devices.py:1038-1206 (FIBER)"),
    "opticomlib_tpu.ops.eyeana": ("Eye metrology kernels",
                                  "devices.py:1635-1868 (GET_EYE)"),
    "opticomlib_tpu.ops.filters": ("Filter kernels",
                                   "devices.py:788-826, 1286-1375"),
    "opticomlib_tpu.ops.pulses": ("Pulse shapes & resampling",
                                  "utils.py:1791-1981"),
    "opticomlib_tpu.ops.prbs": ("PRBS generation",
                                "devices.py:63-182"),
    "opticomlib_tpu.parallel.fiber": ("Sharded SSFM runtime",
                                      "no counterpart (new capability)"),
    "opticomlib_tpu.parallel.pipeline": ("Span pipelining",
                                         "no counterpart (new "
                                         "capability)"),
    "opticomlib_tpu.parallel.dfft": ("Distributed pencil FFT",
                                     "no counterpart (new capability)"),
    "opticomlib_tpu.parallel.multihost": ("Multi-host bring-up",
                                          "no counterpart (new "
                                          "capability)"),
    "opticomlib_tpu.runtime.checkpoint": ("Checkpoint / resume",
                                          "no counterpart (new "
                                          "capability)"),
    "opticomlib_tpu.runtime.cache": ("Persistent compile cache",
                                     "no counterpart (new capability)"),
    "opticomlib_tpu.logger": ("Hierarchical logging", "logger.py"),
    "opticomlib_tpu.utils.profiling": ("Profiling hooks",
                                       "utils.py:268-340 (tic/toc)"),
}


def _first_para(doc):
    if not doc:
        return "*(no docstring)*"
    doc = inspect.cleandoc(doc)
    return doc.split("\n\n")[0].replace("\n", " ")


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod)
                 if not n.startswith("_")
                 and getattr(vars(mod)[n], "__module__", None)
                 == mod.__name__]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        out.append((n, obj))
    return out


def render(mod_name, title, ref):
    mod = importlib.import_module(mod_name)
    lines = [f"# {title}", "",
             f"`{mod_name}` — reference counterpart: `{ref}`.", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    members = _members(mod)
    funcs = [(n, o) for n, o in members
             if inspect.isfunction(o) or inspect.isbuiltin(o)]
    classes = [(n, o) for n, o in members if inspect.isclass(o)]
    others = [(n, o) for n, o in members
              if (n, o) not in funcs and (n, o) not in classes]

    if classes:
        lines += ["## Classes", ""]
        for n, o in classes:
            lines += [f"### `{n}{_sig(o)}`", "", _first_para(o.__doc__),
                      ""]
            methods = sorted(
                (mn, mo) for mn, mo in vars(o).items()
                if not mn.startswith("_") and callable(mo))
            for mn, mo in methods:
                lines += [f"- **`{n}.{mn}{_sig(mo)}`** — "
                          f"{_first_para(mo.__doc__)}"]
            if methods:
                lines.append("")
    if funcs:
        lines += ["## Functions", ""]
        for n, o in funcs:
            lines += [f"### `{n}{_sig(o)}`", "", _first_para(o.__doc__),
                      ""]
    if others:
        lines += ["## Data", ""]
        for n, o in others:
            lines += [f"- **`{n}`** — `{type(o).__name__}`"]
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def main():
    os.makedirs(OUT, exist_ok=True)
    index = ["# API reference", "",
             "Generated from the package docstrings by "
             "`scripts/gen_api_docs.py` (re-run it after changing any "
             "public docstring).", ""]
    for mod_name, (title, ref) in MODULES.items():
        fn = mod_name.replace("opticomlib_tpu.", "").replace(".", "_") \
            + ".md"
        with open(os.path.join(OUT, fn), "w") as f:
            f.write(render(mod_name, title, ref))
        index.append(f"- [{title}]({fn}) — `{mod_name}`")
        print(f"wrote docs/reference/{fn}")
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote docs/reference/index.md")


if __name__ == "__main__":
    main()
