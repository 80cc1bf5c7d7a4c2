"""Project-global configuration (a copy of shallow_ntc_tpu/project_configs.py).

Dataset names resolve to file globs here; the train, itinf and eval
configurations name their datasets by these keys. SHALLOW_NTC_DATA_DIR is
the root of the published sets (Kodak, Tecnick, CLIC, COCO), which are not in
the repository; SHALLOW_NTC_PROJECT_DIR (default: the working directory)
holds data/deadleaves/, which `python -m shallow_ntc_tpu_torch.deadleaves`
generates, and slurm_jobs/.
"""

import os

project_dir = os.environ.get("SHALLOW_NTC_PROJECT_DIR", os.path.abspath("."))
slurm_jobs_dir = os.path.join(project_dir, "slurm_jobs")

_data_root = os.environ.get("SHALLOW_NTC_DATA_DIR", "/data")

dataset_to_globs = dict(
    kodak=os.path.join(_data_root, "kodak", "*.png"),
    kodak_landscape=os.path.join(_data_root, "kodak_landscape", "*.png"),
    tecnick=os.path.join(_data_root, "Tecnick_TESTIMAGES", "RGB", "RGB_OR_1200x1200", "*.png"),
    pval=os.path.join(_data_root, "clic", "pval", "*.png"),
    cocotrain=os.path.join(_data_root, "coco", "train2017", "*.jpg"),
    deadleaves_train=os.path.join(project_dir, "data", "deadleaves", "train", "*.png"),
    deadleaves_valid=os.path.join(project_dir, "data", "deadleaves", "valid", "*.png"),
    deadleaves_eval=os.path.join(project_dir, "data", "deadleaves", "eval", "*.png"),
)

# Abbreviations of config keys in run names (utils/runname.py).
args_abbr = {
    "rd_lambda": "lmbda",
    "bottleneck_size": "csize",
    "hidden_channels": "hc",
    "uq_method": "uq",
}
