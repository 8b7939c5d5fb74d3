# orbital-tpu live viewer service.
# For GPU serving use a CUDA base image / GPU node pool and install
# jax[cuda12]; this image runs the engine on CPU (same code path, smaller N).
FROM python:3.12-slim

WORKDIR /srv
ENV PYTHONUNBUFFERED=1

COPY requirements.txt requirements-app.txt ./
RUN pip install --no-cache-dir -r requirements-app.txt

COPY orbital_tpu/ ./orbital_tpu/
COPY app/ ./app/
COPY native/ ./native/
COPY config.json ./
# optional f64 verification oracle (pure-numpy fallback exists)
RUN apt-get update && apt-get install -y --no-install-recommends g++ make \
    && make -C native && apt-get purge -y g++ make && apt-get autoremove -y \
    && rm -rf /var/lib/apt/lists/* || true

EXPOSE 8000
# single worker: the engine owns the device; scale with replicas, not workers
CMD ["gunicorn", "--bind=0.0.0.0:8000", "--workers=1", "--threads=4", \
     "--max-requests=1200", "--max-requests-jitter=50", \
     "--access-logfile=-", "--error-logfile=-", "app.app:app"]
