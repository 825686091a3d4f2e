"""qilaplace_tpu_torch: the PyTorch / CUDA port of qilaplace_tpu.

This package holds two slices of ``qilaplace_tpu``:

* the n=30 zT pole scan: cross-interpolation encode of a closed-form
  signal into a paired-register state (host numpy f64), the analytic zT
  operator (host numpy f64, assembled on the device), the direct
  ``<config|W|psi>`` readout through the hand-written CUDA kernel K1
  (ops/readout_kernels.py, csrc/coefficient_batch.cu), the closed-form
  oracles and the coarse-to-fine pole search;
* the QFT spectrum path: signal generation, rsvd / TT-SVD encode, the
  gate-built QFT operator, the zip-up apply and a K1 readout, with every
  factorization on the card going through the hand-written CUDA Jacobi
  eigensolver K2 (ops/jacobi_kernels.py, csrc/jacobi_eigh.cu).

Entry points run on the card unless given ``device="cpu"``. It imports
torch and never jax; ``qilaplace_tpu`` stays the reference it is tested
against.

Importing the package turns TF32 off for every float32 matmul
(:func:`~qilaplace_tpu_torch.utils.config.set_highest_precision`).
"""

from qilaplace_tpu_torch.utils.config import set_highest_precision

set_highest_precision()

from qilaplace_tpu_torch.core.mps import (  # noqa: E402
    MPS,
    ZTMPS,
    canonicalize,
    coefficient,
    coefficient_batch,
    compress,
    mps_to_vector,
    norm,
    repad,
    validate,
)
from qilaplace_tpu_torch.core.mpo import (  # noqa: E402
    MPO,
    PairedSiteMPO,
    identity_mpo,
    max_bond,
    mpo_repad,
    mpo_to_dense,
)
from qilaplace_tpu_torch.models.pipelines import (  # noqa: E402
    QFTPipeline,
    ZTPipeline,
)
from qilaplace_tpu_torch.ops.apply import (  # noqa: E402
    apply,
    apply_coefficient_batch,
    apply_mpo_mpo,
    compose_layers,
    embed_window,
    mpo_compress,
    zipper_chain,
)
from qilaplace_tpu_torch.ops.jacobi import jacobi_eigh  # noqa: E402
from qilaplace_tpu_torch.ops.jacobi_kernels import (  # noqa: E402
    jacobi_eigh_k2,
    jacobi_eigh_k2_reference,
)
from qilaplace_tpu_torch.ops.readout_kernels import (  # noqa: E402
    coefficient_batch_k1,
    coefficient_batch_k1_reference,
)
from qilaplace_tpu_torch.ops.rsvd import rsvd  # noqa: E402
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
from qilaplace_tpu_torch.signals.encode import (  # noqa: E402
    signal_mps,
    signal_ztmps,
)
from qilaplace_tpu_torch.signals.generate import generate_signal  # noqa: E402
from qilaplace_tpu_torch.transforms.analytic import (  # noqa: E402
    analytic_zt_mpo,
    assemble_product_cores,
    mpo_from_pack,
    zt_product_pack,
)
from qilaplace_tpu_torch.transforms.qft import build_qft_mpo  # noqa: E402
from qilaplace_tpu_torch.transforms.zt import zt_mpo  # noqa: E402
from qilaplace_tpu_torch.utils.io import load, save  # noqa: E402

__all__ = [
    "MPS", "ZTMPS", "canonicalize", "coefficient", "coefficient_batch",
    "compress", "mps_to_vector", "norm", "repad", "validate",
    "MPO", "PairedSiteMPO", "identity_mpo", "max_bond", "mpo_repad",
    "mpo_to_dense",
    "QFTPipeline", "ZTPipeline",
    "apply", "apply_coefficient_batch", "apply_mpo_mpo", "compose_layers",
    "embed_window", "mpo_compress", "zipper_chain",
    "jacobi_eigh", "jacobi_eigh_k2", "jacobi_eigh_k2_reference",
    "coefficient_batch_k1", "coefficient_batch_k1_reference",
    "PoleSearchResult", "ScanResult", "chi_grid_direct",
    "coarse_to_fine_pole_search", "direct_vals", "kl_from_z", "tighten",
    "z_from_kl",
    "rsvd", "signal_mps_cross", "signal_ztmps_cross", "signal_mps",
    "signal_ztmps", "generate_signal",
    "analytic_zt_mpo", "assemble_product_cores", "mpo_from_pack",
    "zt_product_pack", "build_qft_mpo", "zt_mpo",
    "load", "save",
]
