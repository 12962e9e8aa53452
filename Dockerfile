# Container for rtlsdr_wsprd_tpu (analog of the reference's 2-stage
# Dockerfile: build stage compiles the native host runtime, run stage
# is slim and non-root with the CLI as entrypoint).
#
# Build:  docker build -t rtlsdr-wsprd-tpu .
# Run:    docker run --rm rtlsdr-wsprd-tpu -t          # self-test
#         docker run --rm rtlsdr-wsprd-tpu -f 20m -c A1XYZ -l AB12cd \
#             -i sdr-host:1234                         # rtl_tcp daemon
#
# For GPU hosts, base on an image with JAX's CUDA plugin instead and
# the GPU backend is picked up automatically; the CPU jax wheel here
# runs the full pipeline (slower) for CI and development.

FROM python:3.12-slim-trixie AS build
RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make && rm -rf /var/lib/apt/lists/*
WORKDIR /src
COPY . .
# portable SIMD baseline for a distributable image (the Makefile's
# default -march=native is for builds on the machine that runs them)
RUN make -C native CXXFLAGS="-O3 -std=c++17 -Wall -Wextra -fPIC" \
    && pip wheel --no-deps -w /wheels .

FROM python:3.12-slim-trixie
RUN pip install --no-cache-dir "jax[cpu]" numpy
COPY --from=build /wheels /wheels
RUN pip install --no-cache-dir /wheels/*.whl && rm -rf /wheels
COPY --from=build /src/native/libhostdsp.so \
    /usr/local/lib/python3.12/site-packages/../../../lib/libhostdsp.so
ENV RTLSDR_WSPRD_TPU_NATIVE=/usr/local/lib/libhostdsp.so
RUN useradd -r -m wspr
USER wspr
WORKDIR /home/wspr
ENTRYPOINT ["python", "-m", "rtlsdr_wsprd_tpu.cli"]
CMD ["--help"]
