#!/usr/bin/env python3
"""Print what a host offers the port's native runtime, one JSON line each.

    python3 tools/torch_host_probe.py

The port's host libraries (``mxnet_tpu_torch/_native_build.py``) are C++
built with ``g++``: the engine and the RecordIO reader need only the
compiler, the image pipeline needs libjpeg's and libpng's headers and
libraries, and the two C ABIs embed CPython, so they link against a shared
libpython. ``recordio.pack_img``/``unpack_img`` need cv2 or PIL. This
script reports each of those, then compiles each host source of the
checkout into a temporary directory and reports whether it built, and in
how many seconds. It needs no card; it prints the card's name and power
limit when ``nvidia-smi`` is there.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(cmd, stdin=None):
    try:
        r = subprocess.run(cmd, input=stdin, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return False, str(e)
    return r.returncode == 0, (r.stdout + r.stderr).strip()


def main():
    out = {}
    ok, text = run(["g++", "--version"])
    out["g++"] = text.splitlines()[0] if ok else "missing: " + text
    ok, text = run(["gcc", "--version"])
    out["gcc"] = text.splitlines()[0] if ok else "missing: " + text
    for header in ("jpeglib.h", "png.h", "zlib.h"):
        ok, text = run(["g++", "-x", "c++", "-E", "-"], stdin="#include <%s>\n" % header)
        out[header] = "found" if ok else "missing: " + text.splitlines()[-1][:200]
    out["nvjpeg.h"] = os.path.isfile("/usr/local/cuda/include/nvjpeg.h")
    ok, text = run(["ldconfig", "-p"])
    out["ldconfig_jpeg_png_z"] = sorted({line.split()[0] for line in text.splitlines()[1:]
                                         if any(k in line for k in ("libjpeg", "libpng",
                                                                    "libz.", "libturbojpeg"))})
    for mod in ("cv2", "PIL"):
        ok, text = run([sys.executable, "-c", "import %s; print(%s.__version__)" % (mod, mod)])
        out[mod] = text if ok else "missing: " + text.splitlines()[-1][:200]
    # the codec libraries the wheels carry (hash-named, no headers beside them)
    bundled = []
    for d in {sysconfig.get_paths()["purelib"], sysconfig.get_paths()["platlib"]}:
        for sub in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            if sub.endswith(".libs"):
                bundled += [sub + "/" + n for n in sorted(os.listdir(os.path.join(d, sub)))
                            if re.match(r"lib(jpeg|png|z[.-]|turbojpeg)", n)]
    out["bundled_codec_libs"] = sorted(set(bundled))
    out["Py_ENABLE_SHARED"] = sysconfig.get_config_var("Py_ENABLE_SHARED")
    out["LIBDIR"] = sysconfig.get_config_var("LIBDIR")
    out["LDLIBRARY"] = sysconfig.get_config_var("LDLIBRARY")
    out["python"] = sys.version.split()[0]
    if shutil.which("nvidia-smi"):
        ok, text = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
        out["nvidia_smi"] = text.splitlines()[0] if ok and text else text
    print(json.dumps({"probe": "host", **out}), flush=True)

    inc = sysconfig.get_paths()["include"]
    py = ["-I", inc, "-L", sysconfig.get_config_var("LIBDIR"),
          "-l", "python%d.%d" % sys.version_info[:2]]
    sources = [("engine", "src/engine_native.cc", []),
               ("io", "src/io_native.cc", []),
               ("image", "src/image_native.cc", ["-ljpeg", "-lpng"]),
               ("c_api", "mxnet_tpu_torch/csrc/host/c_api.cc", py),
               ("predict", "mxnet_tpu_torch/csrc/host/predict_api.cc", py)]
    with tempfile.TemporaryDirectory() as tmp:
        for name, src, flags in sources:
            path = os.path.join(ROOT, src)
            if not os.path.isfile(path):
                print(json.dumps({"probe": "build", "lib": name, "source": src,
                                  "built": False, "error": "no such source"}), flush=True)
                continue
            t0 = time.perf_counter()
            ok, text = run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", path,
                            "-o", os.path.join(tmp, "lib%s.so" % name)] + flags)
            rec = {"probe": "build", "lib": name, "source": src, "built": ok,
                   "seconds": time.perf_counter() - t0}
            if not ok:
                rec["error"] = text[-600:]
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
