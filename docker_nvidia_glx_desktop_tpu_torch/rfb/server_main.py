"""CLI entry for the first-party RFB server (the ``x11vnc`` program slot in
the boot plan when ``NOVNC_ENABLE=true``, entrypoint.sh:123): serve the
configured X display — or the synthetic source when no display exists — on
RFB port 5900 with ``BASIC_AUTH_PASSWORD``/``NOVNC_VIEWPASS`` password
semantics, Tight-JPEG rects encoded on the card.

Run: ``python -m docker_nvidia_glx_desktop_tpu_torch.rfb.server_main``."""

from __future__ import annotations

import asyncio
import logging

from ..utils.config import from_env
from .server import RfbServer
from .source import make_source

RFB_PORT = 5900


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    cfg = from_env()
    source = make_source(cfg.display, cfg.sizew, cfg.sizeh)

    on_input = None
    try:
        from ..web.input import make_injector
        on_input = make_injector(cfg.display).handle_rfb
    except Exception:
        logging.exception("no input injector; view-only session")

    server = RfbServer(source=source,
                       password=cfg.effective_basic_auth_password,
                       viewpass=cfg.novnc_viewpass,
                       on_input=on_input)

    async def run():
        await server.start("0.0.0.0", RFB_PORT)
        logging.info("rfb server on :%d (%dx%d)", RFB_PORT,
                     source.width, source.height)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
