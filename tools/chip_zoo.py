#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (the model zoo) alone, on one GPU.

    python3 tools/chip_zoo.py

Builds the kernels, makes the set-up phase 15 reads (phase 7's GC window
and the dense-stress scene), then runs ``chip_smoke.zoo_forwards``,
``zoo_pipeline``, ``zoo_stress`` and ``zoo_dense_step``: every zoo name on
the card against the CPU and in bfloat16, ``exp.main.run`` with
``pinnsf_m`` / ``pinnsf_res`` / ``base``, ``pinnsf_m`` on the dense stress
and in the dense-N finetune step.  Prints the phases' JSON records and
the card's name and power limit; any failure raises.  Needs a CUDA
device.
"""

import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_zoo: needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from piml_tpu_torch import _build
    from piml_tpu_torch.data import make_time_indexed
    from piml_tpu_torch.physics import NeighborConfig
    from piml_tpu_torch.scene import Scene

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    _build.LIBRARY.get()
    dev = torch.device(chip_smoke.DEVICE)
    cfg, _ = chip_smoke.trained_model(dev)
    data = make_time_indexed(cfg, Scene.load(
        os.path.join(ROOT, "repro_work", "gc_sf_repro.npy"), device=dev))
    sc = chip_smoke.stress_scene(dev)
    chip_smoke.zoo_forwards(dev, data)
    with tempfile.TemporaryDirectory() as tmp:
        m_cfg, m_weights = chip_smoke.zoo_pipeline(dev, tmp)
    chip_smoke.zoo_stress(dev, sc, NeighborConfig(), m_cfg, m_weights)
    chip_smoke.zoo_dense_step(dev)


if __name__ == "__main__":
    main()
