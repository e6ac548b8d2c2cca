# spinglass-tpu serving image on CUDA. The host provides the NVIDIA driver
# (run with --gpus all); JAX's CUDA wheels bring the CUDA runtime libraries.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY pyproject.toml README.md ./
COPY spinglass_tpu ./spinglass_tpu
RUN pip install --no-cache-dir "jax[cuda12]" && \
    pip install --no-cache-dir -e ".[cli]"

ENV SGT_ENVIRONMENT=production SGT_LOG_JSON=1
HEALTHCHECK --interval=60s --timeout=30s CMD sgt health || exit 1
ENTRYPOINT ["sgt"]
CMD ["health"]
