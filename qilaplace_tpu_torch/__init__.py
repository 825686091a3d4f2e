"""qilaplace_tpu_torch: the PyTorch / CUDA port of qilaplace_tpu.

This package holds the slice of ``qilaplace_tpu`` that the n=30 zT pole
scan runs: cross-interpolation encode of a closed-form signal into a
paired-register state (host numpy f64), the analytic zT operator (host
numpy f64, assembled on the device), the direct ``<config|W|psi>``
readout through the hand-written CUDA kernel K1 (ops/readout_kernels.py,
csrc/coefficient_batch.cu), the closed-form oracles and the coarse-to-fine
pole search. It imports torch and never jax; ``qilaplace_tpu`` stays the
reference it is tested against.

Importing the package turns TF32 off for every float32 matmul
(:func:`~qilaplace_tpu_torch.utils.config.set_highest_precision`).
"""

from qilaplace_tpu_torch.utils.config import set_highest_precision

set_highest_precision()

from qilaplace_tpu_torch.core.mps import (  # noqa: E402
    MPS,
    ZTMPS,
    coefficient,
    coefficient_batch,
    repad,
    validate,
)
from qilaplace_tpu_torch.core.mpo import (  # noqa: E402
    MPO,
    PairedSiteMPO,
    max_bond,
    mpo_repad,
)
from qilaplace_tpu_torch.models.pipelines import ZTPipeline  # noqa: E402
from qilaplace_tpu_torch.ops.apply import (  # noqa: E402
    apply_coefficient_batch,
    zipper_chain,
)
from qilaplace_tpu_torch.ops.readout_kernels import (  # noqa: E402
    coefficient_batch_k1,
    coefficient_batch_k1_reference,
)
from qilaplace_tpu_torch.scan.pole_scan import (  # noqa: E402
    PoleSearchResult,
    ScanResult,
    chi_grid_direct,
    coarse_to_fine_pole_search,
    direct_vals,
    kl_from_z,
    tighten,
    z_from_kl,
)
from qilaplace_tpu_torch.signals.cross_encode import (  # noqa: E402
    signal_mps_cross,
    signal_ztmps_cross,
)
from qilaplace_tpu_torch.transforms.analytic import (  # noqa: E402
    analytic_zt_mpo,
    assemble_product_cores,
    mpo_from_pack,
    zt_product_pack,
)
from qilaplace_tpu_torch.transforms.zt import zt_mpo  # noqa: E402
from qilaplace_tpu_torch.utils.io import load, save  # noqa: E402

__all__ = [
    "MPS", "ZTMPS", "coefficient", "coefficient_batch",
    "repad", "validate",
    "MPO", "PairedSiteMPO", "max_bond", "mpo_repad",
    "ZTPipeline",
    "apply_coefficient_batch", "zipper_chain",
    "coefficient_batch_k1", "coefficient_batch_k1_reference",
    "PoleSearchResult", "ScanResult", "chi_grid_direct",
    "coarse_to_fine_pole_search", "direct_vals", "kl_from_z", "tighten",
    "z_from_kl",
    "signal_mps_cross", "signal_ztmps_cross",
    "analytic_zt_mpo", "assemble_product_cores", "mpo_from_pack",
    "zt_product_pack", "zt_mpo",
    "load", "save",
]
