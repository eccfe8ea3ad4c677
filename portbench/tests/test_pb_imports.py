"""What a run may load: nothing of JAX or of the JAX package, compared by
whole top-level name; the reference nothing of the program either."""

import json
import subprocess
import sys

from portbench.harness import ROOT, forbidden_modules


def test_forbidden_by_whole_top_level_name():
    mods = {"sgformer_tpu_torch": 1, "sgformer_tpu_torch.nn": 1, "torch": 1,
            "jaxtyping": 1, "flaxen": 1}
    assert forbidden_modules(mods) == []
    bad = dict(mods, **{"sgformer_tpu": 1, "sgformer_tpu.graph": 1, "jax.numpy": 1,
                        "jaxlib": 1, "flax": 1})
    assert forbidden_modules(bad) == ["flax", "jax.numpy", "jaxlib", "sgformer_tpu",
                                      "sgformer_tpu.graph"]


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_the_program_load_no_jax():
    top = _loaded_after("import portbench.run, portbench.calibrate, sgformer_tpu_torch\n"
                        "from portbench.manifest import load_driver\n"
                        "[load_driver(k) for k in ('full_graph_train', 'batch_train', 'serve')]")
    assert not set(top) & {"jax", "jaxlib", "flax", "sgformer_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded_after("import portbench.references.sgformer, portbench.yardstick, "
                        "portbench.graphgen")
    assert not set(top) & {"jax", "jaxlib", "flax", "sgformer_tpu", "sgformer_tpu_torch"}
