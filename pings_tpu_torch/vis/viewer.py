"""Self-contained WebGL viewer for VisPackets.

A copy of ``pings_tpu/vis/viewer.py``: ``write_viewer`` bakes a list of
packets into ONE portable HTML file (raw WebGL1, no external JS): an
orbit/pan/zoom camera, per-layer checkboxes (neural points, scan,
trajectories, keyframe frusta, mesh wireframe, SDF slice), a frame slider
across packets, a point-size control, and rendered rgb/depth thumbnails
per frame. The page is the JAX package's byte for byte except for the
thumbnails, which are encoded by ``data/imageio.encode_png`` (RGB, zlib)
where the JAX package calls matplotlib's ``imsave`` (RGBA): they decode to
the same RGB pixels.
"""

from __future__ import annotations

import base64
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from pings_tpu_torch.data.imageio import encode_png
from pings_tpu_torch.vis.packet import VisPacket, downsample_points


def _b64(a: np.ndarray, dtype) -> str:
    return base64.b64encode(np.ascontiguousarray(a, dtype).tobytes()).decode()


def _png_b64(img: np.ndarray) -> str:
    return base64.b64encode(encode_png(np.asarray(img, np.uint8))).decode()


def _frustum_lines(T_w_c: np.ndarray, fx: float, w: float, h: float,
                   scale: float = 0.4) -> np.ndarray:
    """8 line segments (16 vertices) sketching a camera frustum."""
    z = scale
    x = 0.5 * w / fx * z
    y = 0.5 * h / fx * z
    c = np.zeros(3)
    q = [np.array([-x, -y, z]), np.array([x, -y, z]),
         np.array([x, y, z]), np.array([-x, y, z])]
    segs = []
    for i in range(4):
        segs += [c, q[i], q[i], q[(i + 1) % 4]]
    pts = np.stack(segs)
    return pts @ T_w_c[:3, :3].T + T_w_c[:3, 3]


def _pack_packet(pkt: VisPacket, max_points: int) -> dict:
    d = {"frame_id": int(pkt.frame_id), "images": {}}

    def add_points(key, pts, cols, default_col):
        if pts is None or len(pts) == 0:
            return
        pts, cols = downsample_points(np.asarray(pts, np.float32),
                                      cols, max_points)
        n = len(pts)
        if cols is None:
            cols = np.tile(np.array(default_col, np.uint8), (n, 1))
        d[key] = {"n": n, "pos": _b64(pts, np.float32),
                  "col": _b64(np.asarray(cols), np.uint8)}

    add_points("neural", pkt.neural_points, pkt.neural_colors,
               (90, 160, 255))
    add_points("scan", pkt.scan_points, pkt.scan_colors, (255, 170, 60))

    for key, traj, col in (("traj_est", pkt.traj_est, (30, 220, 120)),
                           ("traj_gt", pkt.traj_gt, (230, 60, 60))):
        if traj is not None and len(traj) >= 2:
            t = np.asarray(traj, np.float32)
            segs = np.empty((2 * (len(t) - 1), 3), np.float32)
            segs[0::2] = t[:-1]
            segs[1::2] = t[1:]
            d[key] = {"n": len(segs), "pos": _b64(segs, np.float32),
                      "rgb": col}

    if pkt.cam_poses is not None and len(pkt.cam_poses):
        intr = (pkt.cam_intrinsics if pkt.cam_intrinsics is not None
                else np.tile([300.0, 300.0, 640, 480],
                             (len(pkt.cam_poses), 1)))
        segs = np.concatenate([
            _frustum_lines(T, k[0], k[2], k[3])
            for T, k in zip(pkt.cam_poses, intr)])
        d["cams"] = {"n": len(segs), "pos": _b64(segs, np.float32),
                     "rgb": (200, 200, 200)}

    if pkt.mesh_verts is not None and pkt.mesh_tris is not None \
            and len(pkt.mesh_tris):
        v = np.asarray(pkt.mesh_verts, np.float32)
        t = np.asarray(pkt.mesh_tris, np.int64)
        e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        if len(e) > 3 * max_points:
            e = e[::int(np.ceil(len(e) / (3 * max_points)))]
        segs = v[e.reshape(-1)]
        d["mesh"] = {"n": len(segs), "pos": _b64(segs, np.float32),
                     "rgb": (150, 120, 255)}

    if pkt.sdf_slice is not None and pkt.sdf_slice_meta is not None:
        s = np.asarray(pkt.sdf_slice, np.float32)
        x0, y0, zz, res = [float(v) for v in pkt.sdf_slice_meta]
        h, w = s.shape
        lim = max(1e-6, float(np.nanmax(np.abs(s))))
        t = np.clip(s / lim, -1, 1)
        rgb = np.zeros((h, w, 3), np.uint8)
        rgb[..., 0] = np.clip(255 * np.maximum(t, 0), 0, 255)  # + = red
        rgb[..., 2] = np.clip(255 * np.maximum(-t, 0), 0, 255)  # - = blue
        rgb[..., 1] = np.clip(255 * (1 - np.abs(t)) * 0.7, 0, 255)
        yy, xx = np.mgrid[0:h, 0:w]
        pts = np.stack([x0 + xx.ravel() * res, y0 + yy.ravel() * res,
                        np.full(h * w, zz)], -1).astype(np.float32)
        pts, cols = downsample_points(pts, rgb.reshape(-1, 3), max_points)
        d["sdf"] = {"n": len(pts), "pos": _b64(pts, np.float32),
                    "col": _b64(cols, np.uint8)}

    for name, img in pkt.images.items():
        d["images"][name] = _png_b64(np.asarray(img))
    return d


_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>pings_tpu viewer</title><style>
body{margin:0;background:#101014;color:#ddd;font:13px sans-serif;overflow:hidden}
#ui{position:absolute;top:8px;left:8px;background:#1b1b22cc;padding:10px;
border-radius:8px;max-width:240px}
#imgs{position:absolute;top:8px;right:8px;max-width:300px;max-height:95vh;
overflow-y:auto}
#imgs img{width:100%;margin-bottom:4px;border:1px solid #333}
label{display:block;margin:2px 0}input[type=range]{width:120px}
canvas{display:block}</style></head><body>
<canvas id="c"></canvas>
<div id="ui">
<b>pings_tpu map viewer</b>
<div id="layers"></div>
<label>frame <input id="frame" type="range" min="0" max="0" value="0">
<span id="fid"></span></label>
<label>point size <input id="psz" type="range" min="1" max="8" value="2"></label>
<div>drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</div>
</div>
<div id="imgs"></div>
<script>
const PACKETS = __DATA__;
const LAYERS = [["neural","neural points"],["scan","scan"],
["traj_est","trajectory"],["traj_gt","gt trajectory"],["cams","keyframes"],
["mesh","mesh"],["sdf","sdf slice"]];
const POINT_LAYERS = new Set(["neural","scan","sdf"]);
function b64f32(s){const b=atob(s);const a=new Float32Array(b.length/4);
const dv=new DataView(new ArrayBuffer(b.length));
for(let i=0;i<b.length;i++)dv.setUint8(i,b.charCodeAt(i));
for(let i=0;i<a.length;i++)a[i]=dv.getFloat32(4*i,true);return a}
function b64u8(s){const b=atob(s);const a=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a}
const canvas=document.getElementById("c");
const gl=canvas.getContext("webgl");
const vs=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
uniform float psz;varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.);
gl_PointSize=psz;vc=col;}`;
const fs=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.);}`;
function shader(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
gl.compileShader(s);return s}
const prog=gl.createProgram();
gl.attachShader(prog,shader(gl.VERTEX_SHADER,vs));
gl.attachShader(prog,shader(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,"p"),locC=gl.getAttribLocation(prog,"col");
const locMVP=gl.getUniformLocation(prog,"mvp"),locPSZ=gl.getUniformLocation(prog,"psz");
let buffers={};  // frame -> layer -> {vbo,cbo,n,mode}
function upload(fi){
 if(buffers[fi])return buffers[fi];
 const out={};const pk=PACKETS[fi];
 for(const[k,_]of LAYERS){const L=pk[k];if(!L)continue;
  const pos=b64f32(L.pos);let col;
  if(L.col){const u=b64u8(L.col);col=new Float32Array(u.length);
   for(let i=0;i<u.length;i++)col[i]=u[i]/255}
  else{col=new Float32Array(L.n*3);
   for(let i=0;i<L.n;i++){col[3*i]=L.rgb[0]/255;col[3*i+1]=L.rgb[1]/255;
   col[3*i+2]=L.rgb[2]/255}}
  const vbo=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,vbo);
  gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
  const cbo=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,cbo);
  gl.bufferData(gl.ARRAY_BUFFER,col,gl.STATIC_DRAW);
  out[k]={vbo,cbo,n:L.n,mode:POINT_LAYERS.has(k)?gl.POINTS:gl.LINES}}
 buffers[fi]=out;return out}
// camera
let yaw=-0.8,pitch=0.5,dist=25,target=[0,0,0];
function center(fi){const pk=PACKETS[fi];
 for(const k of["neural","scan"]){if(pk[k]){const a=b64f32(pk[k].pos);
  let s=[0,0,0];const n=a.length/3;
  for(let i=0;i<n;i++){s[0]+=a[3*i];s[1]+=a[3*i+1];s[2]+=a[3*i+2]}
  target=[s[0]/n,s[1]/n,s[2]/n];return}}}
function mat(){
 const w=canvas.width,h=canvas.height,asp=w/h,f=1/Math.tan(0.4);
 const cp=Math.cos(pitch),sp=Math.sin(pitch),cy=Math.cos(yaw),sy=Math.sin(yaw);
 const eye=[target[0]+dist*cp*cy,target[1]+dist*cp*sy,target[2]+dist*sp];
 const zax=norm([eye[0]-target[0],eye[1]-target[1],eye[2]-target[2]]);
 const xax=norm(cross([0,0,1],zax)),yax=cross(zax,xax);
 const n=0.05,fa=1e4;
 const view=[xax[0],yax[0],zax[0],0,xax[1],yax[1],zax[1],0,
  xax[2],yax[2],zax[2],0,
  -dot(xax,eye),-dot(yax,eye),-dot(zax,eye),1];
 const proj=[f/asp,0,0,0,0,f,0,0,0,0,(fa+n)/(n-fa),-1,0,0,2*fa*n/(n-fa),0];
 return mul(proj,view)}
function norm(v){const l=Math.hypot(v[0],v[1],v[2])||1;
 return[v[0]/l,v[1]/l,v[2]/l]}
function cross(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]]}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2]}
function mul(a,b){const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s}return o}
// ui
const layersDiv=document.getElementById("layers");
const vis={};
for(const[k,label]of LAYERS){const l=document.createElement("label");
 const c=document.createElement("input");c.type="checkbox";
 c.checked=(k!="sdf"&&k!="mesh");c.onchange=()=>{vis[k]=c.checked;draw()};
 vis[k]=c.checked;l.appendChild(c);l.appendChild(document.createTextNode(" "+label));
 layersDiv.appendChild(l)}
const frameEl=document.getElementById("frame");
frameEl.max=PACKETS.length-1;frameEl.value=PACKETS.length-1;
frameEl.oninput=()=>{draw()};
document.getElementById("psz").oninput=()=>draw();
let drag=false,panning=false,lx=0,ly=0;
canvas.onmousedown=e=>{drag=true;panning=e.shiftKey;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
 if(panning){const s=dist*0.002;
  const cy=Math.cos(yaw),sy=Math.sin(yaw);
  target[0]+=(-dx*sy)*s; target[1]+=(dx*cy)*s; target[2]+=dy*s;}
 else{yaw-=dx*0.008;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008))}
 draw()};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault()};
function draw(){
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.06,0.06,0.08,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);
 const fi=+frameEl.value;const bufs=upload(fi);
 document.getElementById("fid").textContent=
  "#"+PACKETS[fi].frame_id+" ("+fi+"/"+(PACKETS.length-1)+")";
 gl.uniformMatrix4fv(locMVP,false,mat());
 gl.uniform1f(locPSZ,+document.getElementById("psz").value);
 for(const[k,_]of LAYERS){if(!vis[k]||!bufs[k])continue;const B=bufs[k];
  gl.bindBuffer(gl.ARRAY_BUFFER,B.vbo);
  gl.enableVertexAttribArray(locP);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,B.cbo);
  gl.enableVertexAttribArray(locC);
  gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
  gl.drawArrays(B.mode,0,B.n)}
 const imgs=document.getElementById("imgs");imgs.innerHTML="";
 const im=PACKETS[fi].images||{};
 for(const name in im){const d=document.createElement("div");
  d.textContent=name;imgs.appendChild(d);
  const e=document.createElement("img");
  e.src="data:image/png;base64,"+im[name];imgs.appendChild(e)}}
center(PACKETS.length-1);draw();window.onresize=draw;
</script></body></html>"""


def write_viewer(out_html: str, packets: Sequence[VisPacket],
                 max_points: int = 150_000) -> str:
    """Bake packets into one standalone HTML viewer; returns the path."""
    if not packets:
        raise ValueError("no packets to visualize")
    data = [_pack_packet(p, max_points) for p in packets]
    html = _HTML.replace("__DATA__", json.dumps(data))
    os.makedirs(os.path.dirname(out_html) or ".", exist_ok=True)
    with open(out_html, "w") as f:
        f.write(html)
    return out_html
