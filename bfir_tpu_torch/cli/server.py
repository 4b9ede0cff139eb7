"""Asyncio TCP control server.

Counterpart of ``bfir_tpu/cli/server.py`` (JAX-free there; copied with the
port's imports).

Replaces the plugin's boost::asio server thread (``cli_server/server.cpp``,
``connection_manager.cpp``; started on a dedicated thread by the plugin,
foo_dsp_bfir.cpp:510-519, default 0.0.0.0:3000, common.h:23). One handler per
connection, commands terminated by CR (LF tolerated), replies CR-terminated.

Usage:
    store = ConfigStore(cfg, on_change=session.reconfigure, device="cuda")
    srv = ControlServer(store, port=3000)
    srv.start()      # background thread running an asyncio loop
    ...
    srv.stop()
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional

from bfir_tpu_torch.cli.protocol import CMD_TERM, CommandHandler
from bfir_tpu_torch.cli.store import ConfigStore
from bfir_tpu_torch.utils.logging import pinfo


class ControlServer:
    def __init__(self, store: ConfigStore, host: str = "0.0.0.0", port: int = 3000,
                 default_dir: Optional[str] = None):
        self.store = store
        self.host = host
        self.port = port
        self.default_dir = default_dir
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        handler = CommandHandler(self.store, self.default_dir)
        buf = b""
        try:
            while not handler.close:
                data = await reader.read(4096)
                if not data:
                    break
                buf += data
                while b"\r" in buf:
                    line, buf = buf.split(b"\r", 1)
                    if buf[:1] == b"\n":  # tolerate CRLF clients
                        buf = buf[1:]
                    text = line.decode("utf-8", "replace").lstrip("\n")
                    if not text:
                        continue
                    reply = handler.handle(text)
                    writer.write((reply + CMD_TERM).encode())
                    await writer.drain()
                    if handler.close:
                        break
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        if self.port == 0:  # ephemeral port for tests
            self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        pinfo("CLI server listening on %s:%d", self.host, self.port)
        async with self._server:
            await self._server.serve_forever()

    def _run(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
        except asyncio.CancelledError:
            pass
        finally:
            self._loop.close()

    def start(self) -> None:
        """g_start_server equivalent (foo_dsp_bfir.cpp:516-519)."""
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bfir-cli-server")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("CLI server failed to start")

    def stop(self) -> None:
        """g_stop_server equivalent (foo_dsp_bfir.cpp:63-70)."""
        if self._loop and self._server:
            def _shutdown():
                self._server.close()
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()
            self._loop.call_soon_threadsafe(_shutdown)
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
