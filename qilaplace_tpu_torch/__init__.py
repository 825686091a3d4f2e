"""qilaplace_tpu_torch: the PyTorch / CUDA port of qilaplace_tpu.

It exports every public name of ``qilaplace_tpu`` and these paths:

* the n=30 zT pole scan: cross-interpolation encode of a closed-form
  signal into a paired-register state (host numpy f64), the analytic zT
  operator (host numpy f64, assembled on the device), the direct
  ``<config|W|psi>`` readout through the hand-written CUDA kernel K1
  (ops/readout_kernels.py, csrc/coefficient_batch.cu), the closed-form
  oracles and the coarse-to-fine pole search;
* the QFT spectrum path: signal generation, rsvd / TT-SVD encode, the
  gate-built QFT operator, the zip-up apply and a K1 readout, with every
  factorization on the card going through the hand-written CUDA Jacobi
  eigensolver K2 (ops/jacobi_kernels.py, csrc/jacobi_eigh.cu);
* the gate-built DT, paired-QFT and zT operators (``build_dt_mpo``,
  ``build_zt_mpo``, ``zt_mpo(engine="gate")``; K2 at every
  factorization), ``DTPipeline``, the analytic DT and QFT operators, and
  the apply-then-read scan (``chi_grid``, ``pole_scan``, the pole search's
  ``readout="apply"``), which reads the product state through K1.

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
    SignalMPS,
    ZTMPS,
    bondindices,
    canonicalize,
    coefficient,
    coefficient_batch,
    compress,
    mps_to_vector,
    norm,
    nsite,
    repad,
    siteindices,
    validate,
)
from qilaplace_tpu_torch.core.mpo import (  # noqa: E402
    MPO,
    PairedSiteMPO,
    SingleSiteMPO,
    identity_mpo,
    max_bond,
    mpo_from_traced,
    mpo_repad,
    mpo_to_dense,
)
from qilaplace_tpu_torch.models.pipelines import (  # noqa: E402
    DTPipeline,
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
    chi_grid,
    chi_grid_direct,
    coarse_to_fine_pole_search,
    direct_vals,
    kl_from_z,
    pole_scan,
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
    analytic_dt_mpo,
    analytic_qft_mpo,
    analytic_zt_mpo,
    assemble_product_cores,
    mpo_from_pack,
    zt_product_pack,
)
from qilaplace_tpu_torch.transforms.dt import build_dt_mpo  # noqa: E402
from qilaplace_tpu_torch.transforms.qft import build_qft_mpo  # noqa: E402
from qilaplace_tpu_torch.transforms.zt import (  # noqa: E402
    build_paired_qft_mpo,
    build_zt_mpo,
    zt_mpo,
)
from qilaplace_tpu_torch.utils.io import load, save  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    # the names of qilaplace_tpu.__all__, in its order
    "MPS", "SignalMPS", "ZTMPS", "nsite", "validate", "coefficient",
    "coefficient_batch", "mps_to_vector", "norm", "canonicalize",
    "compress", "siteindices", "bondindices",
    "MPO", "SingleSiteMPO", "PairedSiteMPO", "identity_mpo", "mpo_to_dense",
    "apply", "apply_coefficient_batch", "apply_mpo_mpo",
    "rsvd", "generate_signal", "signal_mps", "signal_ztmps",
    "build_qft_mpo", "build_dt_mpo", "build_zt_mpo", "zt_mpo",
    "analytic_qft_mpo", "analytic_dt_mpo", "analytic_zt_mpo",
    "chi_grid", "chi_grid_direct", "z_from_kl", "kl_from_z", "pole_scan",
    "coarse_to_fine_pole_search", "tighten",
    # the port's own
    "repad", "max_bond", "mpo_from_traced", "mpo_repad",
    "DTPipeline", "QFTPipeline", "ZTPipeline",
    "compose_layers", "embed_window", "mpo_compress", "zipper_chain",
    "jacobi_eigh", "jacobi_eigh_k2", "jacobi_eigh_k2_reference",
    "coefficient_batch_k1", "coefficient_batch_k1_reference",
    "PoleSearchResult", "ScanResult", "direct_vals",
    "signal_mps_cross", "signal_ztmps_cross",
    "assemble_product_cores", "mpo_from_pack", "zt_product_pack",
    "build_paired_qft_mpo",
    "load", "save",
]
