"""Model configurations of the port, as plain dicts.

TWO_LAYER_SYN is the model_config of shallow_ntc_tpu/mshyper/configs/
two_layer_syn.py (the paper's flagship: ELIC analysis + two-layer residual
synthesis), without the optimizer settings that only training reads.
TWO_LAYER_SYN_RD is the same model as two_layer_syn_rd.py trained it
(rd_lambda 0.01, 30k scheduled steps): the committed checkpoint's config.
"""

import copy

TWO_LAYER_SYN = dict(
    scheduled_num_steps=1_800_000,
    rd_lambda=0.08,
    transform_config=dict(
        analysis=dict(cls="ElicAnalysis", channels=(192, 192, 192, 320)),
        synthesis=dict(
            cls="TwoLayerResSynthesis",
            channels=(12, 3),
            strides=(8, 2),
            kernel_sizes=(13, 5),
            activation_type="igdn",
            res_type="conv",
        ),
    ),
    latent_config=dict(uq=dict(method="unoise")),
)

TWO_LAYER_SYN_RD = copy.deepcopy(TWO_LAYER_SYN)
TWO_LAYER_SYN_RD.update(scheduled_num_steps=30_000, rd_lambda=0.01)

# The hparams that the JAX eval parses back from the run name
# (mshyper-lmbda=0.01-num_steps=30000) into every result record.
TWO_LAYER_SYN_RD_RUNNAME = "mshyper-lmbda=0.01-num_steps=30000"
