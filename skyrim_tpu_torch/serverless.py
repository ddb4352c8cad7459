"""Serverless execution layer (port of skyrim_tpu/serverless.py; reference
skyrim/modal/forecast.py).

The reference offloads forecasts to a Modal container and serves a
JupyterLab over the output volume (modal/forecast.py:44-100).  The same
contract — ``run_inference`` with CLI-mirroring kwargs, a shared output
volume, ``run_analysis`` for inspection — defined lazily so the module
imports where ``modal`` is not installed (neither here nor on the card's
machine): the CLI's ``--remote``/``--modal`` offload then ends in a clear
error.  The container runs the port on a GPU; its image installs the
port's requirements (PyTorch, numpy, scipy), not JAX's.
"""

from __future__ import annotations

import os

from skyrim_tpu_torch.utils.logging import logger

MODAL_ENV = os.environ.get("MODAL_ENV", "dev")
REQUIREMENTS = ("torch", "numpy", "scipy")


def _require_modal():
    try:
        import modal  # type: ignore

        return modal
    except ImportError as e:
        raise RuntimeError(
            "serverless execution requires the `modal` package; install it "
            "and configure credentials, or run the CLI directly on a GPU machine"
        ) from e


def build_app():
    """Construct the Modal app (reference modal/forecast.py:21-57)."""
    modal = _require_modal()

    app = modal.App(f"skyrim-tpu-torch-forecast-{MODAL_ENV}")
    image = (
        modal.Image.debian_slim()
        .pip_install(*REQUIREMENTS)
        .pip_install("skyrim-tpu")
    )
    vol = modal.Volume.from_name("skyrim-tpu-outputs", create_if_missing=True)

    @app.function(image=image, gpu="H100", volumes={"/outputs": vol}, timeout=900)
    def run_inference(**kwargs):
        from skyrim_tpu_torch.cli import run_forecast

        kwargs.setdefault("output_dir", "/outputs")
        result = run_forecast(**kwargs)
        if not str(kwargs["output_dir"]).startswith("s3://"):
            vol.commit()
        return result

    return app, run_inference


def run_remote(**kwargs):
    """Fire a remote forecast with CLI-mirroring kwargs."""
    _, run_inference = build_app()
    logger.info("dispatching remote forecast: %s", kwargs)
    return run_inference.remote(**kwargs)


def build_analysis_app(token: str | None = None):
    """Analysis server over the shared output volume (reference
    modal/forecast.py:60-100): a JupyterLab process on a CPU container
    with the volume mounted, exposed through a ``modal.forward`` tunnel
    guarded by a token."""
    import secrets
    import subprocess

    modal = _require_modal()
    token = token or secrets.token_urlsafe(16)

    app = modal.App(f"skyrim-tpu-torch-analysis-{MODAL_ENV}")
    image = modal.Image.debian_slim().pip_install("jupyterlab", "skyrim-tpu")
    vol = modal.Volume.from_name("skyrim-tpu-outputs", create_if_missing=True)

    @app.function(image=image, volumes={"/outputs": vol}, timeout=86400)
    def run_analysis():
        with modal.forward(8888) as tunnel:
            logger.info("jupyter: %s/?token=%s", tunnel.url, token)
            subprocess.run(
                [
                    "jupyter", "lab",
                    "--no-browser", "--allow-root", "--ip=0.0.0.0",
                    "--port=8888", "--notebook-dir=/outputs",
                    f"--ServerApp.token={token}",
                ],
                check=True,
            )

    return app, run_analysis, token


def main(**kwargs):
    """Local entrypoint mirroring the CLI params (reference
    modal/forecast.py:103-150): ``main(model_name=…, date=…, …)``
    dispatches the forecast remotely."""
    return run_remote(**kwargs)
