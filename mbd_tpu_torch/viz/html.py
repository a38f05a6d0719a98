"""Standalone HTML trajectory viewer (port of ``mbd_tpu/viz/html.py``).

Serializes a System's geoms and a stacked trajectory of link poses into
one self-contained HTML page, with its own small canvas renderer: no
external assets, works offline, renders spheres, capsules, boxes and
planes with an orbitable orthographic camera, play/pause/scrub, and
optional translucent ghost trajectories. It works on numpy arrays (torch
tensors are copied to the host first), and its page is byte for byte the
JAX package's on the same arrays.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..sim.system import BOX, CAPSULE, PLANE, SPHERE, System

_GEOM_NAMES = {PLANE: "plane", SPHERE: "sphere", CAPSULE: "capsule",
               BOX: "box"}


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _system_dict(sys: System) -> dict:
    geoms = []
    for g in range(sys.ngeom):
        t = sys.geom_type[g]
        if t not in _GEOM_NAMES:
            continue
        geoms.append({
            "type": _GEOM_NAMES[t],
            "body": sys.geom_bodyid[g] - 1,   # -1 = world/static
            "pos": sys.host("geom_pos")[g].tolist(),
            "quat": sys.host("geom_quat")[g].tolist(),
            "size": sys.host("geom_size")[g].tolist(),
            "rgba": sys.host("geom_rgba")[g].tolist(),
        })
    return {"geoms": geoms, "link_names": list(sys.link_names)}


def _frames(x_pos: np.ndarray, x_rot: np.ndarray) -> List[dict]:
    return [{"pos": x_pos[t].tolist(), "rot": x_rot[t].tolist()}
            for t in range(x_pos.shape[0])]


def render(sys: System, x_pos, x_rot, dt: float = 0.05,
           ghost_trajs: Optional[Sequence] = None,
           title: str = "mbd_tpu trajectory") -> str:
    """Render a trajectory to a standalone HTML string.

    x_pos: (T, nlink, 3), x_rot: (T, nlink, 4) world link poses.
    ghost_trajs: optional list of (x_pos, x_rot) stacks drawn translucent.
    """
    data = {
        "system": _system_dict(sys),
        "frames": _frames(_host(x_pos), _host(x_rot)),
        "dt": dt,
        "ghosts": [
            _frames(_host(gp), _host(gr))
            for gp, gr in (ghost_trajs or [])],
        "title": title,
    }
    return _TEMPLATE.replace("__DATA__", json.dumps(data))


def render_states(sys: System, pipeline_states, dt: float = 0.05,
                  **kwargs) -> str:
    """Render from stacked states with a leading T axis (their ``x.pos``
    and ``x.rot``, as ``rollout.rollout.rollout_states`` gives them)."""
    return render(sys, pipeline_states.x.pos, pipeline_states.x.rot, dt=dt,
                  **kwargs)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mbd_tpu viewer</title>
<style>
 body{margin:0;background:#1a1d23;color:#dde;font-family:monospace}
 #hud{position:fixed;top:8px;left:8px}
 #bar{position:fixed;bottom:8px;left:8px;right:8px;display:flex;gap:8px}
 #scrub{flex:1}
 canvas{display:block}
 button{background:#333;color:#dde;border:1px solid #555}
</style></head><body>
<canvas id="cv"></canvas>
<div id="hud"></div>
<div id="bar"><button id="play">&#9658;</button>
<input type="range" id="scrub" min="0" value="0"></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
const scrub = document.getElementById('scrub');
const playBtn = document.getElementById('play');
let frame = 0, playing = true, yaw = 0.9, pitch = 0.35, zoom = 120, cx=0, cz=0.6;
scrub.max = DATA.frames.length - 1;

function qrot(q, v){  // wxyz quaternion rotate
  const [w,x,y,z]=q,[vx,vy,vz]=v;
  const tx=2*(y*vz-z*vy), ty=2*(z*vx-x*vz), tz=2*(x*vy-y*vx);
  return [vx+w*tx+y*tz-z*ty, vy+w*ty+z*tx-x*tz, vz+w*tz+x*ty-y*tx];
}
function qmul(a,b){const[aw,ax,ay,az]=a,[bw,bx,by,bz]=b;return[
 aw*bw-ax*bx-ay*by-az*bz, aw*bx+ax*bw+ay*bz-az*by,
 aw*by-ax*bz+ay*bw+az*bx, aw*bz+ax*by-ay*bx+az*bw];}
function proj(p){ // orbit camera, orthographic
  const sy=Math.sin(yaw), cy=Math.cos(yaw), sp=Math.sin(pitch), cp=Math.cos(pitch);
  const x=(p[0]-cx)*cy+(p[1])*sy, y=-(p[0]-cx)*sy+(p[1])*cy, z=p[2]-cz;
  return [cv.width/2 + x*zoom, cv.height/2 - (z*cp - y*sp)*zoom,
          y*cp + z*sp];
}
function geomWorld(g, f){
  if (g.body < 0) return {pos:g.pos, rot:g.quat};
  const b=f.pos[g.body], r=f.rot[g.body];
  return {pos: b.map((v,i)=>v+qrot(r,g.pos)[i]), rot: qmul(r,g.quat)};
}
function drawGeom(g, f, alpha){
  const {pos,rot}=geomWorld(g,f);
  const col=`rgba(${g.rgba.slice(0,3).map(v=>Math.round(v*255)).join(',')},${alpha})`;
  ctx.strokeStyle=ctx.fillStyle=col;
  if(g.type==='plane'){ // grid
    ctx.strokeStyle=`rgba(90,100,110,${alpha*0.8})`;
    for(let i=-10;i<=10;i++){
      let a=proj([i, -10, 0]), b=proj([i, 10, 0]);
      ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
      a=proj([-10, i, 0]); b=proj([10, i, 0]);
      ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
    }
  } else if(g.type==='sphere'){
    const c=proj(pos);
    ctx.beginPath();ctx.arc(c[0],c[1],g.size[0]*zoom,0,7);ctx.fill();
  } else if(g.type==='capsule'){
    const ax=qrot(rot,[0,0,g.size[1]]);
    const a=proj(pos.map((v,i)=>v+ax[i])), b=proj(pos.map((v,i)=>v-ax[i]));
    ctx.lineWidth=2*g.size[0]*zoom; ctx.lineCap='round';
    ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
    ctx.lineWidth=1;
  } else if(g.type==='box'){
    const s=g.size, corners=[];
    for(const sx of[-1,1])for(const sy of[-1,1])for(const sz of[-1,1]){
      const c=qrot(rot,[sx*s[0],sy*s[1],sz*s[2]]);
      corners.push(proj(pos.map((v,i)=>v+c[i])));
    }
    const E=[[0,1],[0,2],[1,3],[2,3],[4,5],[4,6],[5,7],[6,7],[0,4],[1,5],[2,6],[3,7]];
    ctx.lineWidth=1.5;
    for(const [i,j] of E){ctx.beginPath();ctx.moveTo(corners[i][0],corners[i][1]);
      ctx.lineTo(corners[j][0],corners[j][1]);ctx.stroke();}
  }
}
function draw(){
  cv.width=innerWidth; cv.height=innerHeight;
  ctx.clearRect(0,0,cv.width,cv.height);
  const f = DATA.frames[frame];
  // track the first link in x
  if (DATA.frames.length>1 && f.pos.length>0) cx = f.pos[0][0];
  for (const gf of DATA.ghosts){
    const g = gf[Math.min(frame, gf.length-1)];
    for (const geom of DATA.system.geoms)
      if (geom.body>=0) drawGeom(geom, g, 0.15);
  }
  for (const geom of DATA.system.geoms) drawGeom(geom, f, 0.95);
  hud.textContent = `${DATA.title}  frame ${frame+1}/${DATA.frames.length}` +
    `  t=${(frame*DATA.dt).toFixed(2)}s  (drag: orbit, wheel: zoom)`;
  scrub.value = frame;
}
setInterval(()=>{if(playing){frame=(frame+1)%DATA.frames.length;draw();}},
            Math.max(20, DATA.dt*1000));
playBtn.onclick=()=>{playing=!playing;};
scrub.oninput=e=>{playing=false;frame=+e.target.value;draw();};
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
cv.onmousemove=e=>{if(drag){yaw+=(e.clientX-drag[0])*0.01;
  pitch+=(e.clientY-drag[1])*0.01;drag=[e.clientX,e.clientY];draw();}};
cv.onmouseup=()=>drag=null;
cv.onwheel=e=>{zoom*=Math.exp(-e.deltaY*0.001);draw();};
addEventListener('resize',draw);
draw();
</script></body></html>
"""
