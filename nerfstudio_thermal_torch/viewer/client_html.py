"""Embedded single-file web client for the viewer (orbit camera + output
selector); counterpart of nerfstudio_thermal_tpu/viewer/client_html.py,
whose page it serves unchanged. Served by viewer/server.py; talks
JSON-over-websocket: `camera`, `train_control`, `export` and `save_path`
messages up, `outputs`, `train_stats`, `stats` + a binary JPEG,
`train_state`, `exported` and `saved` down."""

CLIENT_HTML = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>nerfstudio-thermal-tpu viewer</title>
<style>
  body { margin:0; background:#111; color:#ddd; font-family:monospace; overflow:hidden; }
  #hud { position:absolute; top:8px; left:8px; background:#000a; padding:8px; border-radius:6px; }
  canvas { display:block; width:100vw; height:100vh; object-fit:contain; }
  select,button { background:#222; color:#ddd; border:1px solid #555; margin:2px; }
</style>
</head>
<body>
<div id="hud">
  <div>output: <select id="output"></select></div>
  <div>split: <select id="split"><option value="">none</option></select>
    <input id="splitfrac" type="range" min="0" max="100" value="50" style="width:6em"/>
  </div>
  <div id="cmap">cmap: <select id="cmapname">
      <option value="default" selected>default</option>
      <option value="turbo">turbo</option>
      <option value="viridis">viridis</option>
      <option value="gray">gray</option>
    </select>
    <label><input id="cmapinv" type="checkbox"/>inv</label>
    <label><input id="cmapnorm" type="checkbox"/>norm</label>
    <input id="cmapmin" type="number" min="0" max="1" step="0.05" value="0" style="width:3.5em"/>
    <input id="cmapmax" type="number" min="0" max="1" step="0.05" value="1" style="width:3.5em"/>
  </div>
  <div>time <input id="time" type="range" min="0" max="1000" value="0" style="width:8em"/>
       <span id="timeval">0.00</span></div>
  <div id="train" style="display:none">
    <button id="pausebtn">pause</button>
    <button id="stepbtn">step 1</button>
    <span id="trainstats"></span>
  </div>
  <div>res: <select id="res">
    <option value="256">256</option>
    <option value="512" selected>512</option>
    <option value="1024">1024</option>
    <option value="1920">1920</option>
  </select></div>
  <div id="stats">connecting...</div>
  <div>fov <input id="fov" type="range" min="20" max="120" value="60" style="width:8em"/>
       <span id="fovval">60</span>&deg;</div>
  <div>
    <button id="addkf">+ keyframe</button>
    <button id="clearkf">clear</button>
    <span id="kfcount">0 kf</span>
  </div>
  <div>
    <select id="kflist" size="4" style="min-width:10em"></select><br/>
    <button id="kfgoto">go to</button>
    <button id="kfdel">delete</button>
    <button id="kfup">&uarr;</button>
    <button id="kfdown">&darr;</button><br/>
    <span id="kfedit" style="display:none">
      dur <input id="kfdur" type="number" value="1" step="0.1" style="width:3em"/>s
      fov <input id="kffov" type="number" value="60" style="width:3em"/>&deg;
    </span>
  </div>
  <div>
    fps <input id="fps" type="number" value="24" style="width:3em"/>
    sec <input id="seconds" type="number" value="4" style="width:3em"/>
    <label><input id="loop" type="checkbox"/> loop</label>
    <button id="preview">preview</button>
    <button id="exportpath">export path</button>
  </div>
  <div>
    <label><input id="cropon" type="checkbox"/> crop</label>
    min <input id="cx0" class="crop" type="number" value="-1" step="0.1"/>
        <input id="cy0" class="crop" type="number" value="-1" step="0.1"/>
        <input id="cz0" class="crop" type="number" value="-1" step="0.1"/><br/>
    max <input id="cx1" class="crop" type="number" value="1" step="0.1"/>
        <input id="cy1" class="crop" type="number" value="1" step="0.1"/>
        <input id="cz1" class="crop" type="number" value="1" step="0.1"/>
  </div>
  <div>
    <select id="exportkind">
      <option value="pointcloud">point cloud (.ply)</option>
      <option value="tsdf">TSDF mesh (.ply)</option>
    </select>
    <button id="exportgeo">export</button>
  </div>
</div>
<canvas id="view"></canvas>
<script>
const canvas = document.getElementById('view');
const ctx = canvas.getContext('2d');
const stats = document.getElementById('stats');
const outputSel = document.getElementById('output');
const resSel = document.getElementById('res');

let theta = 0.5, phi = 1.2, radius = 3.0, target = [0,0,0];
let dragging = false, lastX = 0, lastY = 0;
let ws = null, dirty = true, lastSent = 0;
const fovEl = document.getElementById('fov');
fovEl.addEventListener('input', () => {
  document.getElementById('fovval').textContent = fovEl.value;
  dirty = true;
});

function cameraPose() {
  const ct = Math.cos(theta), st = Math.sin(theta);
  const cp = Math.cos(phi), sp = Math.sin(phi);
  const eye = [ target[0] + radius*cp*ct, target[1] + radius*cp*st, target[2] + radius*sp ];
  // look-at with +z up, OpenGL convention (-z forward)
  let f = [target[0]-eye[0], target[1]-eye[1], target[2]-eye[2]];
  const fn = Math.hypot(...f); f = f.map(v=>v/fn);
  let up = [0,0,1];
  let r = [ f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2], f[0]*up[1]-f[1]*up[0] ];
  const rn = Math.hypot(...r); r = r.map(v=>v/rn);
  const u = [ r[1]*f[2]-r[2]*f[1], r[2]*f[0]-r[0]*f[2], r[0]*f[1]-r[1]*f[0] ];
  return [
    [r[0], u[0], -f[0], eye[0]],
    [r[1], u[1], -f[1], eye[1]],
    [r[2], u[2], -f[2], eye[2]],
  ];
}

canvas.addEventListener('mousedown', e => { dragging = true; lastX=e.clientX; lastY=e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  theta -= (e.clientX-lastX)*0.005;
  phi = Math.min(1.5, Math.max(-1.5, phi + (e.clientY-lastY)*0.005));
  lastX=e.clientX; lastY=e.clientY; dirty = true;
});
canvas.addEventListener('wheel', e => { radius *= Math.exp(e.deltaY*0.001); dirty=true; });
outputSel.addEventListener('change', ()=> dirty=true);
resSel.addEventListener('change', ()=> dirty=true);

// split-output compare (reference control panel split slider)
const splitSel = document.getElementById('split');
const splitFrac = document.getElementById('splitfrac');
splitSel.addEventListener('change', ()=> dirty=true);
splitFrac.addEventListener('input', ()=> dirty=true);

// per-output colormap controls + dnerf time slider (reference
// control_panel.py colormap section / time slider)
const cmapName = document.getElementById('cmapname');
const cmapInv = document.getElementById('cmapinv');
const cmapNorm = document.getElementById('cmapnorm');
const cmapMin = document.getElementById('cmapmin');
const cmapMax = document.getElementById('cmapmax');
for (const el of [cmapName, cmapInv, cmapNorm, cmapMin, cmapMax])
  el.addEventListener('input', ()=> dirty=true);
const timeEl = document.getElementById('time');
timeEl.addEventListener('input', () => {
  document.getElementById('timeval').textContent =
    (parseInt(timeEl.value)/1000).toFixed(2);
  dirty = true;
});
function colormapOpts() {
  return {
    name: cmapName.value,
    invert: cmapInv.checked,
    normalize: cmapNorm.checked,
    min: parseFloat(cmapMin.value) || 0,
    max: isNaN(parseFloat(cmapMax.value)) ? 1 : parseFloat(cmapMax.value),
  };
}

// train controls (reference viewer pause-training button + stats markdown)
const trainDiv = document.getElementById('train');
const pauseBtn = document.getElementById('pausebtn');
let trainPaused = false;
pauseBtn.addEventListener('click', () => {
  if (!ws || ws.readyState !== 1) return;
  ws.send(JSON.stringify({type: 'train_control',
                          action: trainPaused ? 'resume' : 'pause'}));
});
document.getElementById('stepbtn').addEventListener('click', () => {
  if (ws && ws.readyState === 1)
    ws.send(JSON.stringify({type: 'train_control', action: 'step'}));
});

// crop / scene-box tool (reference viewer control panel crop controls)
function cropBox() {
  if (!document.getElementById('cropon').checked) return null;
  const v = id => parseFloat(document.getElementById(id).value) || 0;
  return [[v('cx0'), v('cy0'), v('cz0')], [v('cx1'), v('cy1'), v('cz1')]];
}
document.getElementById('cropon').addEventListener('change', ()=> dirty=true);
for (const el of document.querySelectorAll('.crop'))
  el.addEventListener('change', ()=> dirty=true);

// export tab (reference viewer/export_panel.py): run geometry exporters
document.getElementById('exportgeo').addEventListener('click', () => {
  if (!ws || ws.readyState !== 1) return;
  stats.textContent = 'exporting...';
  ws.send(JSON.stringify({
    type: 'export',
    kind: document.getElementById('exportkind').value,
    crop: cropBox(),
  }));
});

// render panel (reference viewer/render_panel.py): record/edit keyframes,
// preview the interpolated path live, export a camera_path.json for
// `ns-render camera-path`. Each keyframe stores both the pose matrix (for
// the server-side slerp export) and the orbit state (for go-to/preview).
const keyframes = [];
const kfcount = document.getElementById('kfcount');
const kflist = document.getElementById('kflist');
function refreshKfList() {
  kfcount.textContent = `${keyframes.length} kf`;
  const sel = kflist.selectedIndex;
  kflist.innerHTML = '';
  keyframes.forEach((k, i) => {
    const opt = document.createElement('option');
    opt.value = i;
    opt.textContent = `kf ${i}: th=${k.orbit[0].toFixed(2)} ph=${k.orbit[1].toFixed(2)} r=${k.orbit[2].toFixed(2)} ${k.duration.toFixed(1)}s ${k.fov.toFixed(0)}°`;
    kflist.appendChild(opt);
  });
  if (sel >= 0 && sel < keyframes.length) kflist.selectedIndex = sel;
  syncKfEdit();
}
// per-keyframe duration/fov editing (reference render_panel keyframe props)
const kfEdit = document.getElementById('kfedit');
const kfDur = document.getElementById('kfdur');
const kfFov = document.getElementById('kffov');
function syncKfEdit() {
  const i = kflist.selectedIndex;
  kfEdit.style.display = i >= 0 ? '' : 'none';
  if (i >= 0) { kfDur.value = keyframes[i].duration; kfFov.value = keyframes[i].fov; }
}
kflist.addEventListener('change', syncKfEdit);
kfDur.addEventListener('change', () => {
  const i = kflist.selectedIndex;
  if (i >= 0) { keyframes[i].duration = Math.max(parseFloat(kfDur.value) || 1, 0.1); refreshKfList(); }
});
kfFov.addEventListener('change', () => {
  const i = kflist.selectedIndex;
  if (i >= 0) { keyframes[i].fov = parseFloat(kfFov.value) || 60; refreshKfList(); }
});
document.getElementById('addkf').addEventListener('click', () => {
  keyframes.push({pose: cameraPose(), orbit: [theta, phi, radius, ...target],
                  fov: parseFloat(fovEl.value) || 60, duration: 1.0});
  refreshKfList();
});
document.getElementById('clearkf').addEventListener('click', () => {
  keyframes.length = 0; refreshKfList();
});
document.getElementById('kfdel').addEventListener('click', () => {
  const i = kflist.selectedIndex;
  if (i >= 0) { keyframes.splice(i, 1); refreshKfList(); }
});
document.getElementById('kfgoto').addEventListener('click', () => {
  const i = kflist.selectedIndex;
  if (i < 0) return;
  [theta, phi, radius] = keyframes[i].orbit;
  target = keyframes[i].orbit.slice(3);
  dirty = true;
});
function moveKf(delta) {
  const i = kflist.selectedIndex, j = i + delta;
  if (i < 0 || j < 0 || j >= keyframes.length) return;
  [keyframes[i], keyframes[j]] = [keyframes[j], keyframes[i]];
  refreshKfList(); kflist.selectedIndex = j;
}
document.getElementById('kfup').addEventListener('click', () => moveKf(-1));
document.getElementById('kfdown').addEventListener('click', () => moveKf(1));

// live path preview: interpolate the orbit states client-side and let the
// progressive renderer stream coarse frames along the way
let previewing = false;
document.getElementById('preview').addEventListener('click', () => {
  if (previewing || keyframes.length < 2) return;
  previewing = true;
  const secs = parseFloat(document.getElementById('seconds').value) || 4;
  const t0 = performance.now();
  const saved = [theta, phi, radius, ...target];
  function stepPreview(now) {
    const u = Math.min((now - t0) / (secs * 1000), 1) * (keyframes.length - 1);
    const i = Math.min(Math.floor(u), keyframes.length - 2), f = u - i;
    const a = keyframes[i].orbit, b = keyframes[i + 1].orbit;
    theta = a[0] + f * (b[0] - a[0]);
    phi = a[1] + f * (b[1] - a[1]);
    radius = a[2] + f * (b[2] - a[2]);
    target = [0, 1, 2].map(k => a[3 + k] + f * (b[3 + k] - a[3 + k]));
    dirty = true;
    if (u < keyframes.length - 1) requestAnimationFrame(stepPreview);
    else {
      [theta, phi, radius] = saved; target = saved.slice(3);
      previewing = false; dirty = true;
    }
  }
  requestAnimationFrame(stepPreview);
});
document.getElementById('exportpath').addEventListener('click', () => {
  if (!ws || ws.readyState !== 1 || keyframes.length === 0) return;
  const loopChecked = document.getElementById('loop').checked;
  ws.send(JSON.stringify({
    type: 'save_path',
    keyframes: keyframes.map(k => k.pose),
    fovs: keyframes.map(k => k.fov),  // per-keyframe fov (render panel)
    // per-transition durations: [K-1], or [K] with the loop-back segment
    durations: keyframes.slice(0, loopChecked ? keyframes.length
                                              : keyframes.length - 1)
                        .map(k => k.duration),
    fov: parseFloat(fovEl.value) || 60,
    fps: parseFloat(document.getElementById('fps').value) || 24,
    seconds: parseFloat(document.getElementById('seconds').value) || 4,
    loop: document.getElementById('loop').checked,
    width: parseInt(resSel.value) * 2,
    height: Math.round(parseInt(resSel.value) * 2 * 9 / 16),
  }));
});

function connect() {
  ws = new WebSocket(`ws://${location.hostname}:${parseInt(location.port)+1}`);
  ws.binaryType = 'arraybuffer';
  ws.onopen = () => {
    stats.textContent = 'connected'; dirty = true;
    if (!window._ticking) { window._ticking = true; requestAnimationFrame(tick); }
  };
  ws.onclose = () => { stats.textContent = 'disconnected, retrying...'; setTimeout(connect, 1000); };
  ws.onmessage = ev => {
    if (typeof ev.data === 'string') {
      const msg = JSON.parse(ev.data);
      if (msg.type === 'outputs') {
        outputSel.innerHTML = '';
        splitSel.innerHTML = '<option value="">none</option>';
        for (const o of msg.names) {
          const opt = document.createElement('option');
          opt.value = o; opt.textContent = o;
          outputSel.appendChild(opt);
          const opt2 = document.createElement('option');
          opt2.value = o; opt2.textContent = o;
          splitSel.appendChild(opt2);
        }
      } else if (msg.type === 'train_stats') {
        trainDiv.style.display = '';
        const parts = [`step ${msg.step}`];
        if (msg.rays_per_sec) parts.push(`${(msg.rays_per_sec/1e3).toFixed(1)}k rays/s`);
        if (msg.loss !== undefined) parts.push(`loss ${msg.loss}`);
        if (msg.eta_s !== undefined) parts.push(`eta ${Math.round(msg.eta_s)}s`);
        document.getElementById('trainstats').textContent = parts.join('  ');
      } else if (msg.type === 'train_state') {
        if (msg.error) { stats.textContent = msg.error; return; }
        trainDiv.style.display = '';
        trainPaused = !!msg.paused;
        pauseBtn.textContent = trainPaused ? 'resume' : 'pause';
      } else if (msg.type === 'stats') {
        if (msg.error) { stats.textContent = `render error: ${msg.error}`; return; }
        const tag = msg.final ? '' : ' (refining...)';
        stats.textContent = `${msg.render_ms.toFixed(0)} ms  ${msg.width}x${msg.height}${tag}`;
      } else if (msg.type === 'saved') {
        stats.textContent = msg.error ? `export failed: ${msg.error}` : `saved ${msg.path}`;
      } else if (msg.type === 'exported') {
        stats.textContent = msg.error ? `export failed: ${msg.error}` : `exported ${msg.path}`;
      }
      return;
    }
    const blob = new Blob([ev.data], {type: 'image/jpeg'});
    createImageBitmap(blob).then(img => {
      canvas.width = img.width; canvas.height = img.height;
      ctx.drawImage(img, 0, 0);
    });
  };
}

// The server coalesces camera messages (latest wins) and streams
// progressively refined frames back, so the client just throttles sends.
function tick(now) {
  if (ws && ws.readyState === 1 && dirty && now - lastSent > 33) {
    dirty = false; lastSent = now;
    ws.send(JSON.stringify({
      type: 'camera',
      c2w: cameraPose(),
      width: parseInt(resSel.value),
      aspect: window.innerWidth / window.innerHeight,
      output: outputSel.value || 'rgb',
      output_split: splitSel.value || null,
      split_fraction: parseInt(splitFrac.value) / 100,
      crop: cropBox(),
      fov: parseFloat(fovEl.value) || 60,
      colormap: colormapOpts(),
      time: parseInt(timeEl.value) > 0 ? parseInt(timeEl.value)/1000 : null,
    }));
  }
  requestAnimationFrame(tick);
}
connect();
</script>
</body>
</html>
"""
