#!/bin/bash
# What a machine offers the port's host image library (ops/native_image.py):
# libjpeg headers for g++, nvJPEG in the CUDA toolkit, cores, compiler, and
# which of cv2, PIL and torchvision its Python imports.  Reads only.
#
#     bash fhpe_tpu_torch/tools/probe_jpeg_route.sh
cuda=${CUDA_HOME:-/usr/local/cuda}
echo "== jpeglib.h through g++ -E"
echo '#include <jpeglib.h>' | g++ -E -x c++ - >/dev/null 2>&1; echo "rc=$?"
echo "== ldconfig -p: libjpeg, nvjpeg"
ldconfig -p | grep -E 'libjpeg|nvjpeg'
echo "== $cuda/include/nvjpeg.h and libnvjpeg"
ls -l "$cuda/include/nvjpeg.h"; ls "$cuda/lib64/" | grep -i jpeg
echo "== nproc"; nproc
echo "== g++"; g++ --version | head -1
echo "== python"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
for m in cv2 PIL torchvision; do
    python3 -c "import $m; print('$m', getattr($m, '__version__', '?'), $m.__file__)" 2>&1 | tail -1
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
