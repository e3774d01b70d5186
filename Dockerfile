# Prover-service image (reference analog: keyless-zk-proofs/Dockerfile).
# Runs on an NVIDIA GPU: the host provides the driver (run with --gpus);
# this image holds the service, JAX's CUDA build, the native witness
# engine toolchain, and a procured setup.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        gcc libc6-dev git \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY pyproject.toml README.md ./
COPY keyless_zk_tpu ./keyless_zk_tpu
COPY native ./native

RUN pip install --no-cache-dir "jax[cuda12]" pyyaml && \
    pip install --no-cache-dir -e . --no-deps

# Procure the content-addressed setup at build time (testing setups only;
# production deployments mount a released setup instead).
# RUN python -m keyless_zk_tpu.tooling.setup_tool procure-testing-setup

EXPOSE 8083 9100
ENTRYPOINT ["keyless-zk-tpu-prover-service"]
