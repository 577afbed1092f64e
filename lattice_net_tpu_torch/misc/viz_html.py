"""A self-contained interactive HTML point-cloud viewer, a copy of
``lattice_net_tpu/misc/viz_html.py`` (byte-equal files).

One ``.html`` file with the (subsampled) cloud embedded as base64
float32/uint8 buffers and a small canvas renderer: orbit with the mouse,
scroll to zoom, no server and no external assets, so it opens offline on
any machine.  It complements ``misc/viz.py``'s exact PLY dumps, trading
exactness (subsampling above ``max_points``) for convenience.
"""

from __future__ import annotations

import base64
from pathlib import Path

import numpy as np

__all__ = ["write_html_viewer"]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body {margin:0; background:#111; color:#ddd; font:12px monospace; overflow:hidden}
 #hud {position:fixed; left:8px; top:8px; user-select:none}
 canvas {display:block}
</style></head><body>
<div id="hud">__TITLE__ — __NPTS__ pts · drag: orbit · shift-drag: pan · wheel: zoom</div>
<canvas id="c"></canvas>
<script>
const XYZ_B64 = "__XYZ__";
const RGB_B64 = "__RGB__";
function decode(b64, ctor) {
  const bin = atob(b64); const bytes = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
  return new ctor(bytes.buffer);
}
const xyz = decode(XYZ_B64, Float32Array);
const rgb = decode(RGB_B64, Uint8Array);
const n = xyz.length / 3;
// center + scale
let cx=0, cy=0, cz=0;
for (let i=0;i<n;i++){cx+=xyz[3*i];cy+=xyz[3*i+1];cz+=xyz[3*i+2];}
cx/=n; cy/=n; cz/=n;
let r=0;
for (let i=0;i<n;i++){const dx=xyz[3*i]-cx,dy=xyz[3*i+1]-cy,dz=xyz[3*i+2]-cz;
  r=Math.max(r,dx*dx+dy*dy+dz*dz);}
r=Math.sqrt(r)||1;
const canvas=document.getElementById('c'), ctx=canvas.getContext('2d');
let yaw=0.6, pitch=-1.0, zoom=0.9, panx=0, pany=0;
function draw(){
  const w=canvas.width=innerWidth, h=canvas.height=innerHeight;
  ctx.fillStyle='#111'; ctx.fillRect(0,0,w,h);
  const img=ctx.getImageData(0,0,w,h), px=img.data;
  const cyaw=Math.cos(yaw), syaw=Math.sin(yaw);
  const cp=Math.cos(pitch), sp=Math.sin(pitch);
  const s=0.45*Math.min(w,h)/r*zoom;
  for(let i=0;i<n;i++){
    const x=xyz[3*i]-cx, y=xyz[3*i+1]-cy, z=xyz[3*i+2]-cz;
    const rx=cyaw*x+syaw*y, ry=-syaw*x+cyaw*y;
    const rz=cp*z-sp*ry, ry2=sp*z+cp*ry;
    const sx=(w/2+panx+rx*s)|0, sy=(h/2+pany-rz*s)|0;
    if(sx<0||sy<0||sx>=w||sy>=h) continue;
    const o=4*(sy*w+sx);
    px[o]=rgb[3*i]; px[o+1]=rgb[3*i+1]; px[o+2]=rgb[3*i+2]; px[o+3]=255;
  }
  ctx.putImageData(img,0,0);
}
let drag=false, shift=false, lx=0, ly=0;
canvas.onmousedown=e=>{drag=true;shift=e.shiftKey;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-lx, dy=e.clientY-ly; lx=e.clientX; ly=e.clientY;
  if(shift){panx+=dx;pany+=dy;}else{yaw+=dx*0.01;pitch+=dy*0.01;}
  requestAnimationFrame(draw);};
window.onwheel=e=>{zoom*=Math.exp(-e.deltaY*0.001);requestAnimationFrame(draw);};
window.onresize=draw;
draw();
</script></body></html>
"""


def write_html_viewer(
    path,
    xyz: np.ndarray,
    rgb: np.ndarray,
    title: str = "lattice_net_tpu cloud",
    max_points: int = 400_000,
) -> Path:
    """Write a standalone HTML viewer of an (N, 3) cloud with (N, 3) uint8
    colors (use :func:`misc.viz.class_color_map` for label coloring).
    Subsamples uniformly above ``max_points`` to keep the file portable."""
    xyz = np.asarray(xyz, np.float32)
    rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
    if not (xyz.shape == (len(xyz), 3) and rgb.shape == (len(xyz), 3)):
        raise ValueError(f"write_html_viewer needs (N, 3) xyz and rgb, got {xyz.shape} and {rgb.shape}")
    if len(xyz) > max_points:
        sel = np.random.default_rng(0).choice(len(xyz), max_points, replace=False)
        sel.sort()
        xyz, rgb = xyz[sel], rgb[sel]
    html = (
        _TEMPLATE.replace("__TITLE__", title)
        .replace("__NPTS__", str(len(xyz)))
        .replace("__XYZ__", base64.b64encode(np.ascontiguousarray(xyz).tobytes()).decode())
        .replace("__RGB__", base64.b64encode(np.ascontiguousarray(rgb).tobytes()).decode())
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(html)
    return path
