"""OpenCV's learned 256-pair rBRIEF test pattern (data, not code).

A copy of dspslam_tpu/frontend/orb_pattern.py.

The 1024 integers of `bit_pattern_31_` (reference src/
ORBextractor.cc:151-410 — itself OpenCV's orb.cpp table, learned offline
per the ORB paper's greedy uncorrelated-test selection). Shipping the
exact table is the bit-compatibility contract with OpenCV-extracted
descriptors and the pretrained DBoW2 ORBvoc vocabulary; stored
base64(int8) and reshaped to this framework's (256, 2, 2) [pair,
endpoint, (x, y)] pattern layout (frontend/orb.py:brief_pattern).
"""

import base64

import numpy as np

_B64 = (
    "CP0JBQQCB/T1CfgCB/QM8wLzAgwB+QEG/vb+/PPz9fjz/fT3CgQLCfP4+Pf1B/cMBwcMBvz7/QDz"
    "AvT99wD5BQz6DP/9Bv4M+vP8+AvzDPgEBwUBBf0K/QP5Bgz4+fr+/gv/9vMM+Ar5A/v9/AL9B/b0"
    "+gsF9Ab5BfoH/wEABPsJCwvzBAcEDAL/BAT89P4H+Pv59gQLCQwA+AHz8/74Av3+/gP6Cfz3CAwK"
    "BwAJAQMH+wv28/r1AAoHDAH6/foMCvcM/PMI+PTzAPj8AwMHCAUHCvn/BwH0A/YFBgL8A/bzAPMF"
    "8/n0DPMD9Qj5DPwHBvYMCPf/+fr++wAM9AX5BQP2CPP5+fwF/f7/+QIJBfX18/vz/wYA/wX9BQL8"
    "8/wM9/r3BvT2+PwKAgz9BwwMDPnz+gX8Cf0EB/8MAvkG+wHzC/QF/Qf++gf4DPnz+fX0Af0MDAL6"
    "AwD8A/7z//MBCQcBCPoB/wMMCQEMBv/3/wPz8/YFBwcKDAz7DAkGAwcLBfMGCgL0AgMDCAT6AgYM"
    "8wn0CgP4BPkJ9Qz8+gEMAvgG9wf8AgMD/gYDCwAD/Qj4BwgJA/X7+vz2C/sK+/j9DPYF9wAI/wz6"
    "BPoG9fYM+AcE/gYH/gD+DPv4+wIH+goM9/P4+Pvz+/4I+Anz9/X3AAH4Af4H/AkB/gH//Av6DPX0"
    "9/oEAwcHDAUFCggA/AII9wz78wAHAgz/AgEHBQsH9wMFBvjz/PgJ+wn9/fz5/fQGBQgA+Qb6DPMG"
    "+/4B9gMKBAEI/P7+AvMC9AwM/vMA+gQBCQP69v37/fP/AQcFDPUE/gX58wn3+wcBCAYH+AcG+fz5"
    "AfgL+fjzBvT4AgQDCQr7DAP6+/oHCP0J+AL0Agj1/vYD9PP59/UA9vsF/QsI/vP/DP/4AAnz9fT7"
    "9v72C/0J/vMC/QMC9/P8APwG/fb8DP75+vX8CQb9BgvzC/sFCwsMBgf7DP7/DAAH/Pj9/vkB+gfz"
    "9Pjz+f76+PgF+vf7//wF8wf4CgEFBfMBAArzCQwK/wX4Cvf/CwHz9/36Av/2AQzzAfj2CPUK+gLz"
    "A/oH8wz39vb7+fb4+PME+ggFAwwI8/wC/f0F8wr0BPMF//cJ/AMAAwP39AH6AQMCBPj29vYJCPMM"
    "DPj0+vsCAgMHCgYL+AYICPT5CvoF/ff9Cf/z/wX9+f0E+P74AwQCDAwC+wMLBvcL8wP/BwwL/wwE"
    "/QD9BgT1BAwC/AIB9vr4AfMH9QHzDPXzBgAL8wD/AQTzA/f+9wj6/fP6+P4F9wgKAgcD9//6//8J"
    "BQv+C/0M+AMAAwX/BAAKA/oEBfMA9gUFCAwLCAkJ+gf8CPT2BPYJBwMMBAn5Cv4HAAz+//oA9Q=="
)


def reference_pattern() -> np.ndarray:
    """(256, 2, 2) int32 [x, y] endpoint offsets of the learned table."""
    flat = np.frombuffer(base64.b64decode(_B64), dtype=np.int8)
    return flat.reshape(256, 2, 2).astype(np.int32)
