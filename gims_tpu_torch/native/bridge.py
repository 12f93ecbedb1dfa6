"""ctypes bridge to the port's native support library.

The port's copy of ``gims_tpu/native/bridge.py``: the reference's CPPbridge
method surface (reference: utils/library.py:433-580; GeometricFilter,
CreateMatcher/KnnMatch, query-node iteration, GeometricFilterFromMatcher,
FastMatCombi) over ``native/matchlib.cc``, host C++ (the JAX package's is
host C++ too; no kernel). The library is compiled at first use, never at
import:

    g++ -O3 -fPIC -std=c++17 -shared -o gims_tpu_torch/_build/libgims_native_<hash>.so \
        gims_tpu_torch/native/matchlib.cc

under a name keyed by a hash of the source and flags, as ``_build.py`` keys
the CUDA library, so an edited source is rebuilt. Keypoints are (N, 2)
arrays or objects with a ``pt`` pair.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from gims_tpu_torch import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "matchlib.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(_build.BUILD_DIR, f"libgims_native_{h.hexdigest()[:16]}.so")


def build_library(force: bool = False) -> str:
    """Compile matchlib.cc if its library is not built yet; return its path."""
    out = library_path()
    with _lock:
        if force or not os.path.exists(out):
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
            tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
            try:
                cmd = [cxx, *CXX_FLAGS, "-o", os.path.join(tmp, "lib.so"), SOURCE]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(os.path.join(tmp, "lib.so"), out)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    return out


class CPPbridge:
    def __init__(self, lib_path: str | None = None):
        if lib_path is None:
            lib_path = build_library()
        self.lib = ctypes.cdll.LoadLibrary(lib_path)
        self.MatcherPtr = None
        self.last_i1_list = np.empty(0, dtype=ctypes.c_int)
        self.last_i2_list = np.empty(0, dtype=ctypes.c_int)

        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        bp = ctypes.POINTER(ctypes.c_bool)
        L = self.lib
        L.GeometricFilter.argtypes = [
            fp, fp, bp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_bool,
        ]
        L.GeometricFilter.restype = None
        L.GeometricFilterFromNodes.argtypes = [
            ctypes.c_void_p, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_bool,
        ]
        L.GeometricFilterFromNodes.restype = None
        L.NumberOfFilteredMatches.argtypes = [ctypes.c_void_p]
        L.NumberOfFilteredMatches.restype = ctypes.c_int
        L.ArrayOfFilteredMatches.argtypes = [ctypes.c_void_p, ip]
        L.ArrayOfFilteredMatches.restype = None
        L.newMatcher.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float]
        L.newMatcher.restype = ctypes.c_void_p
        L.deleteMatcher.argtypes = [ctypes.c_void_p]
        L.KnnMatcher.argtypes = [
            ctypes.c_void_p, fp, fp, ctypes.c_int, fp, fp, ctypes.c_int,
            ctypes.c_int,
        ]
        L.KnnMatcher.restype = None
        L.GetQueryNodeLength.argtypes = [ctypes.c_void_p]
        L.GetQueryNodeLength.restype = ctypes.c_int
        L.GetData_from_QueryNode.argtypes = [ctypes.c_void_p, ip, ip, fp]
        L.GetData_from_QueryNode.restype = None
        for name in ("FirstQueryNode", "LastQueryNode"):
            getattr(L, name).argtypes = [ctypes.c_void_p]
            getattr(L, name).restype = ctypes.c_void_p
        for name in ("NextQueryNode", "PrevQueryNode"):
            getattr(L, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            getattr(L, name).restype = ctypes.c_void_p
        L.FastMatCombi.argtypes = [
            ctypes.c_int, fp, ip, ip, fp, fp, ctypes.c_int, ip, ip,
        ]
        L.FastMatCombi.restype = None

    # --- geometric filtering (reference: library.py:480-496) ---
    def GeometricFilter(self, scr_pts, im1, dts_pts, im2, Filer="ORSA_H",
                        precision=10, verb=False):
        filercode = 1 if Filer == "ORSA_F" else 0
        scr = np.ascontiguousarray(scr_pts, dtype=np.float32).reshape(-1)
        dts = np.ascontiguousarray(dts_pts, dtype=np.float32).reshape(-1)
        n = len(scr) // 2
        mask = np.zeros(n, dtype=ctypes.c_bool)
        T = np.zeros(9, dtype=np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        bp = ctypes.POINTER(ctypes.c_bool)
        h1, w1 = im1.shape[:2]
        h2, w2 = im2.shape[:2]
        self.lib.GeometricFilter(
            scr.ctypes.data_as(fp), dts.ctypes.data_as(fp),
            mask.ctypes.data_as(bp), T.ctypes.data_as(fp),
            n, w1, h1, w2, h2, filercode, ctypes.c_float(precision), verb,
        )
        return mask.astype(bool), T.astype(np.float64).reshape(3, 3)

    # --- KNN matching (reference: library.py:542-558) ---
    def CreateMatcher(self, desc_dim, k=1, sim_thres=0.7):
        self.MatcherPtr = self.lib.newMatcher(k, desc_dim,
                                              ctypes.c_float(sim_thres))

    def KnnMatch(self, Qkps, Qdesc, Tkps, Tdesc, FastCode=0):
        """Qkps/Tkps: (N, 2) arrays, or keypoints with a ``pt`` pair."""
        fp = ctypes.POINTER(ctypes.c_float)
        qk = _kps_to_array(Qkps)
        tk = _kps_to_array(Tkps)
        qd = np.ascontiguousarray(Qdesc, np.float32)
        td = np.ascontiguousarray(Tdesc, np.float32)
        self.lib.KnnMatcher(
            self.MatcherPtr, qk.ctypes.data_as(fp), qd.ctypes.data_as(fp),
            len(qd), tk.ctypes.data_as(fp), td.ctypes.data_as(fp),
            len(td), FastCode,
        )

    def GetMatches_from_QueryNode(self, qn):
        n = self.lib.GetQueryNodeLength(qn)
        if n <= 0:
            return []
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        qidx = np.zeros(1, dtype=np.int32)
        tidx = np.zeros(n, dtype=np.int32)
        sims = np.zeros(n, dtype=np.float32)
        self.lib.GetData_from_QueryNode(
            qn, qidx.ctypes.data_as(ip), tidx.ctypes.data_as(ip),
            sims.ctypes.data_as(fp),
        )
        return [(int(qidx[0]), int(tidx[i]), float(sims[i]))
                for i in range(n)]

    def FirstLast_QueryNodes(self):
        return (self.lib.FirstQueryNode(self.MatcherPtr),
                self.lib.LastQueryNode(self.MatcherPtr))

    def NextQueryNode(self, qn):
        return self.lib.NextQueryNode(self.MatcherPtr, qn)

    def PrevQueryNode(self, qn):
        return self.lib.PrevQueryNode(self.MatcherPtr, qn)

    def all_matches(self):
        """Convenience: iterate all query nodes -> [(q, t, dist), ...]."""
        out = []
        first, last = self.FirstLast_QueryNodes()
        qn = first
        while qn:
            out.extend(self.GetMatches_from_QueryNode(qn))
            if qn == last:
                break
            qn = self.NextQueryNode(qn)
        return out

    def GeometricFilterFromMatcher(self, im1, im2, Filer="ORSA_H",
                                   precision=24, verb=False):
        filercode = 1 if Filer == "ORSA_F" else 0
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        T = np.zeros(9, dtype=np.float32)
        h1, w1 = im1.shape[:2]
        h2, w2 = im2.shape[:2]
        self.lib.GeometricFilterFromNodes(
            self.MatcherPtr, T.ctypes.data_as(fp), w1, h1, w2, h2,
            filercode, ctypes.c_float(precision), verb,
        )
        nfm = self.lib.NumberOfFilteredMatches(self.MatcherPtr)
        fm = np.zeros(3 * nfm, dtype=np.int32)
        self.lib.ArrayOfFilteredMatches(self.MatcherPtr,
                                        fm.ctypes.data_as(ip))
        matches = [(int(fm[3 * i]), int(fm[3 * i + 1]), int(fm[3 * i + 2]))
                   for i in range(nfm)]
        return matches, T.astype(np.float64).reshape(3, 3)

    # --- FastMatCombi (reference: library.py:560-580) ---
    def PrepareForFastMatCombi(self, len_i_list):
        self.last_i1_list = -1 * np.ones(len_i_list, dtype=ctypes.c_int)
        self.last_i2_list = -1 * np.ones(len_i_list, dtype=ctypes.c_int)

    def FastMatCombi(self, bP, i_list, ps1, j_list, ps2, MemStepImg,
                     MemStepBlock=0):
        ip = ctypes.POINTER(ctypes.c_int)
        fp = ctypes.POINTER(ctypes.c_float)
        i1 = np.ascontiguousarray(i_list, np.int32)
        i2 = np.ascontiguousarray(j_list, np.int32)
        self.lib.FastMatCombi(
            len(self.last_i1_list), bP.ctypes.data_as(fp),
            i1.ctypes.data_as(ip), i2.ctypes.data_as(ip),
            ps1.ctypes.data_as(fp), ps2.ctypes.data_as(fp),
            ctypes.c_int(MemStepImg),
            self.last_i1_list.ctypes.data_as(ip),
            self.last_i2_list.ctypes.data_as(ip),
        )
        self.last_i1_list = i1.copy()
        self.last_i2_list = i2.copy()


def _kps_to_array(kps):
    """(N, 2) keypoints, or objects with a ``pt`` pair, as flat float32."""
    if isinstance(kps, np.ndarray):
        return np.ascontiguousarray(kps, np.float32).reshape(-1)
    return np.array([c for kp in kps for c in kp.pt], np.float32)
