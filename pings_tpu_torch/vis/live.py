"""Live viewer + control server for a running SLAM process.

A copy of ``pings_tpu/vis/live.py``:
``python -m pings_tpu_torch.vis.live <run_dir> [--port 8008]`` serves, from
the run directory of a live (or finished) run:

- ``GET /``         — the WebGL viewer baked from the packets currently
                      on disk, with a control panel injected (pause /
                      step / stop, vis cadence, mesh / SDF-slice / render
                      layer toggles, slice-height slider). The page
                      polls ``/status`` and re-loads when new packets
                      arrive.
- ``GET /status``   — ``{"n_packets": N, "latest": frame_id, "control":
                      {...}}``.
- ``POST /control`` — merge the JSON body into ``<run_dir>/control.json``,
                      which the command line's frame loop polls every
                      frame (``vis/control.py``).

Standard library only (``http.server``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PANEL = """
<div id="ctrlpanel" style="position:fixed;top:8px;right:8px;z-index:50;
background:rgba(20,22,30,.92);color:#dde;padding:10px 12px;
border-radius:8px;font:12px sans-serif;min-width:180px">
 <b>live control</b><br/>
 <label><input type="checkbox" id="c_pause"/> pause</label>
 <button id="c_step">step 1</button>
 <button id="c_stop">stop run</button><br/>
 <label>vis every <input type="number" id="c_vis" min="0" style="width:3em"/></label><br/>
 <label><input type="checkbox" id="c_mesh"/> mesh</label>
 <label><input type="checkbox" id="c_slice"/> sdf slice</label>
 <label><input type="checkbox" id="c_render" checked/> render</label><br/>
 <label>slice h <input type="range" id="c_sh" min="-3" max="3" step="0.1"
  value="0"/><span id="c_shv">0.0</span> m</label><br/>
 <span id="c_status" style="color:#8c8">connecting...</span>
</div>
<script>
(function(){
 const S = (id)=>document.getElementById(id);
 let lastN = -1;
 function push(extra){
   const body = Object.assign({
     pause: S('c_pause').checked,
     mesh_on: S('c_mesh').checked,
     sdf_slice_on: S('c_slice').checked,
     render_on: S('c_render').checked,
     sdf_slice_height: parseFloat(S('c_sh').value),
     vis_every: S('c_vis').value === '' ? null : parseInt(S('c_vis').value),
   }, extra||{});
   fetch('/control', {method:'POST', body: JSON.stringify(body)});
 }
 ['c_pause','c_mesh','c_slice','c_render','c_vis'].forEach(
   id=>S(id).addEventListener('change', ()=>push()));
 S('c_sh').addEventListener('input', ()=>{
   S('c_shv').textContent = parseFloat(S('c_sh').value).toFixed(1);});
 S('c_sh').addEventListener('change', ()=>push());
 S('c_step').onclick = ()=>push({pause:true, step:1});
 S('c_stop').onclick = ()=>{ if(confirm('stop the SLAM run?')) push({stop:true}); };
 setInterval(()=>{
   fetch('/status').then(r=>r.json()).then(st=>{
     S('c_status').textContent =
       'frame '+st.latest+' · '+st.n_packets+' packets';
     if (lastN >= 0 && st.n_packets > lastN && !S('c_pause').checked)
       location.reload();
     lastN = st.n_packets;
   }).catch(()=>{ S('c_status').textContent = 'server gone'; });
 }, 3000);
})();
</script>
"""


def _load_packets(run_dir: str, max_packets: int = 40):
    from pings_tpu_torch.vis.packet import VisPacket

    files = sorted(glob.glob(os.path.join(run_dir, "vis", "*.npz")))
    return [VisPacket.load(f) for f in files[-max_packets:]], len(files)


def _bake(run_dir: str) -> bytes:
    from pings_tpu_torch.vis.viewer import write_viewer

    packets, _ = _load_packets(run_dir)
    if not packets:
        return (b"<html><body style='font:14px sans-serif'>no vis packets"
                b" yet (run the CLI with --vis-every N)" + _PANEL.encode()
                + b"</body></html>")
    with tempfile.TemporaryDirectory() as td:
        p = write_viewer(os.path.join(td, "v.html"), packets)
        html = open(p).read()
    if "</body>" in html:
        html = html.replace("</body>", _PANEL + "</body>")
    else:
        html += _PANEL
    return html.encode()


def make_handler(run_dir: str):
    ctl_path = os.path.join(run_dir, "control.json")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body: bytes, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] == "/":
                self._send(200, _bake(run_dir))
            elif self.path == "/status":
                packets, n = _load_packets(run_dir, max_packets=1)
                ctl = {}
                if os.path.exists(ctl_path):
                    try:
                        ctl = json.load(open(ctl_path))
                    except Exception:
                        pass
                st = {"n_packets": n,
                      "latest": packets[-1].frame_id if packets else -1,
                      "control": ctl}
                self._send(200, json.dumps(st).encode(),
                           "application/json")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            if self.path != "/control":
                return self._send(404, b"not found")
            ln = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(ln) or b"{}")
                assert isinstance(body, dict)
            except Exception:
                return self._send(400, b"bad json")
            cur = {}
            if os.path.exists(ctl_path):
                try:
                    cur = json.load(open(ctl_path))
                except Exception:
                    pass
            cur.update(body)
            tmp = ctl_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(cur, f)
            os.replace(tmp, ctl_path)
            self._send(200, json.dumps(cur).encode(), "application/json")

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("run_dir")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)
    srv = ThreadingHTTPServer((args.host, args.port),
                              make_handler(args.run_dir))
    print(f"live viewer on http://{args.host}:{args.port}/ "
          f"(run dir: {args.run_dir})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
