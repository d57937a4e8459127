"""Reference-exact float64 NumPy oracles.

These modules re-state the C++ reference's hot numerical contracts
(open_karto's correlative scan matcher + mapper graph,
sparse_bundle_adjustment's SysSPA2d, lesson4's hector GN matcher + log-odds map update + gmapping
hit/visit mapper, lesson5's undistortion, and lesson3's CSM sm_icp
PL-ICP) in plain NumPy float64, preserving
every quantization, tie rule, and quirk — including the ones that look
like bugs — so the TPU implementation can be differential-tested against
"what the reference computes" rather than against synthetic truth alone
(tests/test_oracle_parity.py).

They are deliberately slow scalar/NumPy code: fidelity over speed.
"""

from tpuslam_torch.oracle.gmapping import OracleGmappingMap
from tpuslam_torch.oracle.plicp import OracleCsm, OracleLdp
from tpuslam_torch.oracle.icp_pcl import OraclePclIcp
from tpuslam_torch.oracle.hector import OracleHectorMap, OracleHectorMatcher
from tpuslam_torch.oracle.undistort import OracleUndistorter
from tpuslam_torch.oracle.spa2d import OracleSpa2d
from tpuslam_torch.oracle.karto import (
    OracleScan,
    OracleScanMatcher,
    OracleMapper,
)

__all__ = [
    "OracleCsm",
    "OracleGmappingMap",
    "OracleLdp",
    "OraclePclIcp",
    "OracleHectorMap",
    "OracleHectorMatcher",
    "OracleUndistorter",
    "OracleSpa2d",
    "OracleScan",
    "OracleScanMatcher",
    "OracleMapper",
]
