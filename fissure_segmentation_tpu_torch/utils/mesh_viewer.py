"""Interactive 3-D mesh viewer: self-contained offline HTML/WebGL export.

The reference visualizes fitted fissure meshes interactively through Open3D's
GLFW window (reference visualization.py:5-16, o3d draw_geometries); a TPU pod
or CI host has no display server and Open3D is a heavyweight native
dependency. The TPU-native replacement renders the same scene in the
browser: :func:`export_mesh_viewer` writes ONE dependency-free HTML file
(inline WebGL1 renderer, ~6 kB of JS; mesh data embedded as base64
Float32) with orbit/zoom/pan controls, per-class colors, visibility toggles
and double-sided Lambert shading. Open it locally or serve it from the run
directory — no install, no egress, works over SSH port-forwards.

Used by train/evaluation.py artifact export (one viewer per case next to the
.obj files) and usable standalone:

    from fissure_segmentation_tpu_torch.utils.mesh_viewer import export_mesh_viewer
    export_mesh_viewer(case_result.meshes, "case01_viewer.html",
                       points=case_result.kpts[:, ::-1],
                       point_labels=case_result.labels)

A copy of the JAX package's utils/mesh_viewer.py (the port imports nothing of
that package); tests/test_torch_repairs.py holds it equal to the original.
"""
from __future__ import annotations

import base64
import json
import os

import numpy as np

# label colors, RGB in [0,1] — same palette family as visualization.py
_COLORS = [(0.9, 0.3, 0.25), (0.25, 0.6, 0.9), (0.3, 0.8, 0.4),
           (0.9, 0.7, 0.2), (0.7, 0.4, 0.85), (0.5, 0.5, 0.5)]


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()
                            ).decode("ascii")


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;user-select:none}
 #hud b{font-size:14px}
 .tog{cursor:pointer;margin-right:10px}
 .off{opacity:.35;text-decoration:line-through}
 #help{position:fixed;bottom:8px;left:10px;color:#888}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>__TITLE__</b><br><span id="togs"></span></div>
<div id="help">drag: orbit &nbsp; shift-drag: pan &nbsp; wheel: zoom &nbsp;
 keys 1-9: toggle layers</div>
<script>
"use strict";
const DATA = __DATA__;
function decode(b64){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new Float32Array(u.buffer);}
const canvas=document.getElementById("c");
const gl=canvas.getContext("webgl",{antialias:true});
const VS=`attribute vec3 p;attribute vec3 n;uniform mat4 mvp;uniform mat3 nm;
 varying vec3 vn;void main(){gl_Position=mvp*vec4(p,1.0);vn=nm*n;
 gl_PointSize=3.0;}`;
const FS=`precision mediump float;uniform vec3 col;varying vec3 vn;
 void main(){vec3 N=normalize(vn);float d=abs(N.z);
 gl_FragColor=vec4(col*(0.25+0.75*d),1.0);}`;
function sh(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,"p"),locN=gl.getAttribLocation(prog,"n");
const uMVP=gl.getUniformLocation(prog,"mvp"),uNM=gl.getUniformLocation(prog,"nm"),
 uCol=gl.getUniformLocation(prog,"col");
// build layers: triangle soups with flat normals, point clouds as GL_POINTS
let lo=[1e30,1e30,1e30],hi=[-1e30,-1e30,-1e30];
const layers=DATA.layers.map(L=>{
 const v=decode(L.v);let n=null;
 for(let i=0;i<v.length;i+=3){for(let k=0;k<3;k++){
  if(v[i+k]<lo[k])lo[k]=v[i+k];if(v[i+k]>hi[k])hi[k]=v[i+k];}}
 if(L.kind==="mesh"){n=new Float32Array(v.length);
  for(let t=0;t<v.length;t+=9){
   const ax=v[t+3]-v[t],ay=v[t+4]-v[t+1],az=v[t+5]-v[t+2];
   const bx=v[t+6]-v[t],by=v[t+7]-v[t+1],bz=v[t+8]-v[t+2];
   let nx=ay*bz-az*by,ny=az*bx-ax*bz,nz=ax*by-ay*bx;
   const l=Math.hypot(nx,ny,nz)||1;nx/=l;ny/=l;nz/=l;
   for(let k=0;k<3;k++){n[t+3*k]=nx;n[t+3*k+1]=ny;n[t+3*k+2]=nz;}}}
 const vb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,vb);
 gl.bufferData(gl.ARRAY_BUFFER,v,gl.STATIC_DRAW);
 let nb=null;if(n){nb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,nb);
  gl.bufferData(gl.ARRAY_BUFFER,n,gl.STATIC_DRAW);}
 return{kind:L.kind,name:L.name,color:L.color,vb:vb,nb:nb,
        count:v.length/3,on:true};});
const ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const rad=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3);
let az=0.6,el=0.4,dist=2.2*rad,panX=0,panY=0;
// hud toggles
const togs=document.getElementById("togs");
layers.forEach((L,i)=>{const s=document.createElement("span");
 s.className="tog";s.id="tog"+i;
 s.style.color="rgb("+L.color.map(c=>Math.round(255*c)).join(",")+")";
 s.textContent="["+(i+1)+"] "+L.name;
 s.onclick=()=>{L.on=!L.on;s.classList.toggle("off",!L.on);draw();};
 togs.appendChild(s);});
window.addEventListener("keydown",e=>{const i=e.keyCode-49;
 if(i>=0&&i<layers.length)document.getElementById("tog"+i).onclick();});
// matrices
function mat(){
 const a=Math.cos(az),b=Math.sin(az),c=Math.cos(el),d=Math.sin(el);
 const eye=[ctr[0]+dist*c*b,ctr[1]+dist*d,ctr[2]+dist*c*a];
 const f=norm3([ctr[0]-eye[0],ctr[1]-eye[1],ctr[2]-eye[2]]);
 const r=norm3(cross(f,[0,1,0])),u=cross(r,f);
 const tx=-dot(r,eye)+panX,ty=-dot(u,eye)+panY,tz=dot(f,eye);
 const V=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0, tx,ty,tz,1];
 const asp=canvas.width/canvas.height,fov=0.8,
  nz=0.01*rad,fz=20*rad,t=1/Math.tan(fov/2);
 const P=[t/asp,0,0,0, 0,t,0,0, 0,0,(fz+nz)/(nz-fz),-1, 0,0,2*fz*nz/(nz-fz),0];
 return{mvp:mul44(P,V),nm:[r[0],u[0],-f[0],r[1],u[1],-f[1],r[2],u[2],-f[2]]};}
function cross(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]];}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(v){const l=Math.hypot(v[0],v[1],v[2])||1;
 return[v[0]/l,v[1]/l,v[2]/l];}
function mul44(A,B){const C=new Array(16).fill(0);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
  C[j*4+i]+=A[k*4+i]*B[j*4+k];return C;}
function draw(){
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.enable(gl.DEPTH_TEST);gl.clearColor(0.066,0.066,0.066,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const m=mat();gl.uniformMatrix4fv(uMVP,false,new Float32Array(m.mvp));
 gl.uniformMatrix3fv(uNM,false,new Float32Array(m.nm));
 for(const L of layers){if(!L.on)continue;
  gl.uniform3fv(uCol,L.color);
  gl.bindBuffer(gl.ARRAY_BUFFER,L.vb);
  gl.enableVertexAttribArray(locP);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  if(L.nb){gl.bindBuffer(gl.ARRAY_BUFFER,L.nb);
   gl.enableVertexAttribArray(locN);
   gl.vertexAttribPointer(locN,3,gl.FLOAT,false,0,0);
   gl.drawArrays(gl.TRIANGLES,0,L.count);}
  else{gl.disableVertexAttribArray(locN);gl.vertexAttrib3f(locN,0,0,1);
   gl.drawArrays(gl.POINTS,0,L.count);}}}
let drag=false,pan=false,mx=0,my=0;
canvas.onmousedown=e=>{drag=true;pan=e.shiftKey;mx=e.clientX;my=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-mx,dy=e.clientY-my;mx=e.clientX;my=e.clientY;
 if(pan){panX+=dx*0.002*dist;panY-=dy*0.002*dist;}
 else{az-=dx*0.006;el=Math.min(1.5,Math.max(-1.5,el+dy*0.006));}
 draw();};
canvas.onwheel=e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001);draw();};
window.onresize=draw;
draw();
</script></body></html>
"""


def export_mesh_viewer(meshes, path: str, points: np.ndarray | None = None,
                       point_labels: np.ndarray | None = None,
                       names=None, title: str = "fissure meshes") -> str:
    """Write a self-contained interactive HTML viewer for fitted meshes.

    :param meshes: list of (tris (T, 3, 3) float xyz, valid (T,) bool) per
        class — the CaseResult.meshes / fit_fissure_surfaces format
    :param points: optional (N, 3) xyz keypoint cloud, rendered as points
    :param point_labels: optional (N,) int labels — splits `points` into one
        toggleable layer per label (0 = background-colored)
    :param names: optional layer names (default "fissure 1..K")
    :return: the path written
    """
    layers = []
    for i, (tris, valid) in enumerate(meshes):
        tris = np.asarray(tris, np.float32)
        valid = np.asarray(valid, bool)
        v = tris[valid].reshape(-1, 3) if tris.size else tris.reshape(-1, 3)
        name = (names[i] if names is not None and i < len(names)
                else f"fissure {i + 1}")
        layers.append({"kind": "mesh", "name": name,
                       "color": list(_COLORS[i % len(_COLORS)]),
                       "v": _b64(v)})
    if points is not None:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if point_labels is not None:
            lab = np.asarray(point_labels).reshape(-1)
            for c in np.unique(lab):
                sel = pts[lab == c]
                col = (_COLORS[(int(c) - 1) % len(_COLORS)] if c > 0
                       else (0.45, 0.45, 0.45))
                layers.append({"kind": "points", "name": f"points {int(c)}",
                               "color": list(col), "v": _b64(sel)})
        else:
            layers.append({"kind": "points", "name": "keypoints",
                           "color": [0.8, 0.8, 0.8], "v": _b64(pts)})

    html = (_HTML.replace("__TITLE__", title)
            .replace("__DATA__", json.dumps({"layers": layers})))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
