"""Every public name of raytpu has a counterpart in raytpu_torch.

The port does everything raytpu does; this table is the record of where.
It walks raytpu's modules (pkgutil.walk_packages) and collects every
public top-level function and class that a module defines itself (jitted
and custom_vjp functions included, not the names a module imports), and
the JAX bench's (bench.py).  Each must have a row naming a raytpu_torch
attribute, and each row must resolve.  Where the counterpart has another
form, the row names the argument that carries raytpu's function, and the
counterpart must take it; the comment says how it maps.  A row of the
same form takes raytpu's parameters in raytpu's order, bar the named
exceptions, and may add its own only after them.  The port says cuda
where raytpu says pallas.

The repo's other entry points are its scripts under tools/.  TOOL_PORTS
holds each of them: ported (the port's module, run as python -m, with
raytpu's flags and defaults plus --cpu), of another form (where its work
lives in the port), or not ported (why).  A script without an entry fails.
"""

import ast
import importlib
import inspect
import os
import pkgutil

import bench
import raytpu

# raytpu.<module>.<name> -> raytpu_torch.<attribute path>, or
# (path, the argument of it that carries the raytpu function).
COUNTERPARTS = {
    "bench.main": "raytpu_torch.bench.main",
    "raytpu.cli.build_parser": "raytpu_torch.cli.build_parser",
    "raytpu.cli.compare_ppms": "raytpu_torch.cli.compare_ppms",
    "raytpu.cli.main": "raytpu_torch.cli.main",
    "raytpu.cli.make_scene": "raytpu_torch.cli.make_scene",
    "raytpu.config.RenderConfig": "raytpu_torch.config.RenderConfig",
    "raytpu.grad.exposure_image_loss": "raytpu_torch.grad.exposure_image_loss",
    "raytpu.grad.finite_difference_check": "raytpu_torch.grad.finite_difference_check",
    "raytpu.grad.fit_scene": "raytpu_torch.grad.fit_scene",
    "raytpu.grad.image_loss": "raytpu_torch.grad.image_loss",
    "raytpu.grad.loss_and_grad": "raytpu_torch.grad.loss_and_grad",
    # loss_and_grad(backend="cuda"): the kernel pair.
    "raytpu.grad.loss_and_grad_pallas": ("raytpu_torch.grad.loss_and_grad", "backend"),
    "raytpu.grad.loss_and_grad_pallas_packed": "raytpu_torch.grad.loss_and_grad_packed",
    "raytpu.grad.loss_and_grad_sharded": "raytpu_torch.grad.loss_and_grad_sharded",
    "raytpu.grad.loss_and_grad_wavefront": "raytpu_torch.grad.loss_and_grad_wavefront",
    "raytpu.grad.pack_target": "raytpu_torch.grad.pack_target",
    "raytpu.image.max_colour_value": "raytpu_torch.image.max_colour_value",
    "raytpu.image.read_ppm": "raytpu_torch.image.read_ppm",
    "raytpu.image.tone_map": "raytpu_torch.image.tone_map",
    "raytpu.image.write_ppm": "raytpu_torch.image.write_ppm",
    "raytpu.kernels.culling.beam_live_mask": "raytpu_torch.kernels.culling.beam_live_mask",
    "raytpu.kernels.culling.bin_key": "raytpu_torch.kernels.culling.bin_key",
    "raytpu.kernels.culling.direction_octant": "raytpu_torch.kernels.culling.direction_octant",
    "raytpu.kernels.culling.pack_tile_scene": "raytpu_torch.kernels.culling.pack_tile_scene",
    "raytpu.kernels.culling.scene_bounds": "raytpu_torch.kernels.culling.scene_bounds",
    "raytpu.kernels.culling.segment_hull_live_mask":
        "raytpu_torch.kernels.culling.segment_hull_live_mask",
    "raytpu.kernels.culling.spatial_cell": "raytpu_torch.kernels.culling.spatial_cell",
    "raytpu.kernels.culling.tile_bounds": "raytpu_torch.kernels.culling.tile_bounds",
    "raytpu.kernels.trace_pallas.pack_pixel_tiles": "raytpu_torch.kernels.pack_pixel_tiles",
    "raytpu.kernels.trace_pallas.render_image_pallas": "raytpu_torch.kernels.render_image_cuda",
    "raytpu.kernels.trace_pallas.render_pixels_pallas": "raytpu_torch.kernels.render_pixels_cuda",
    "raytpu.kernels.trace_pallas.render_pixels_pallas_ad":
        "raytpu_torch.kernels.render_pixels_cuda_ad",
    "raytpu.kernels.trace_pallas.render_tiles_pallas_ad":
        "raytpu_torch.kernels.render_tiles_cuda_ad",
    "raytpu.kernels.trace_pallas.tile_mask": "raytpu_torch.kernels.tile_mask",
    "raytpu.kernels.trace_pallas.unpack_pixel_tiles": "raytpu_torch.kernels.unpack_pixel_tiles",
    "raytpu.kernels.wavefront.render_image_wavefront":
        "raytpu_torch.kernels.wavefront.render_image_wavefront",
    "raytpu.kernels.wavefront.render_pixels_wavefront":
        "raytpu_torch.kernels.wavefront.render_pixels_wavefront",
    # raytpu's build_library builds its host oracle with g++, again when
    # stale or on `force`.  The port builds each kernel's source, the
    # oracle's too (native.ORACLE), with nvcc at first use, into a library
    # named by a hash of its sources and flags: no library is ever stale,
    # so there is nothing to force.
    "raytpu.native.build_library": ("raytpu_torch.kernels.trace_cuda.CudaKernel",
                                    "source"),
    "raytpu.native.render_native": "raytpu_torch.native.render_native",
    # Process-wide setters in raytpu; arguments of render_native here.
    "raytpu.native.set_approx_mask": ("raytpu_torch.native.render_native", "approx_mask"),
    "raytpu.native.set_fma_mask": ("raytpu_torch.native.render_native", "fma_mask"),
    # The port keeps one form, the host one of raytpu.image.
    "raytpu.ops.algebra.max_colour_value": "raytpu_torch.image.max_colour_value",
    "raytpu.ops.algebra.is_zero": "raytpu_torch.ops.algebra.is_zero",
    "raytpu.ops.algebra.safe_sqrt": "raytpu_torch.ops.algebra.safe_sqrt",
    "raytpu.ops.algebra.solve_quadratic": "raytpu_torch.ops.algebra.solve_quadratic",
    "raytpu.ops.geometry.Hit": "raytpu_torch.ops.geometry.Hit",
    "raytpu.ops.geometry.closest_hit": "raytpu_torch.ops.geometry.closest_hit",
    "raytpu.ops.geometry.dot3": "raytpu_torch.ops.geometry.dot3",
    "raytpu.ops.geometry.normalize": "raytpu_torch.ops.geometry.normalize",
    "raytpu.ops.geometry.primary_container": "raytpu_torch.ops.geometry.primary_container",
    "raytpu.ops.geometry.ray_sphere_t": "raytpu_torch.ops.geometry.ray_sphere_t",
    "raytpu.ops.shading.is_significant": "raytpu_torch.ops.shading.is_significant",
    "raytpu.ops.shading.matte_light_sum": "raytpu_torch.ops.shading.matte_light_sum",
    "raytpu.ops.shading.polarised_reflection": "raytpu_torch.ops.shading.polarised_reflection",
    "raytpu.ops.shading.reflect": "raytpu_torch.ops.shading.reflect",
    "raytpu.ops.shading.refract": "raytpu_torch.ops.shading.refract",
    "raytpu.oracle.OracleScene": "raytpu_torch.oracle.OracleScene",
    "raytpu.oracle.camera_dirs_oracle": "raytpu_torch.oracle.camera_dirs_oracle",
    "raytpu.oracle.render_oracle": "raytpu_torch.oracle.render_oracle",
    "raytpu.oracle.trace_oracle": "raytpu_torch.oracle.trace_oracle",
    "raytpu.parallel.mesh.describe_devices": "raytpu_torch.parallel.mesh.describe_devices",
    # raytpu reads a sharded global array back; one process a rank gathers
    # each rank's rows over its Mesh.
    "raytpu.parallel.mesh.gather_image": ("raytpu_torch.parallel.mesh.gather_image",
                                          "rows"),
    "raytpu.parallel.mesh.initialize_distributed":
        "raytpu_torch.parallel.mesh.initialize_distributed",
    # A JAX mesh over a device list with a named axis; a rank's Mesh is its
    # place in the process group and the one device it renders on (the
    # axis is always PIXEL_AXIS).
    "raytpu.parallel.mesh.make_mesh": ("raytpu_torch.parallel.mesh.make_mesh", "device"),
    # A NamedSharding of the pixel axis; one process a rank renders its
    # pixel set (offset, count, stride) of the mesh.
    "raytpu.parallel.mesh.pixel_sharding": ("raytpu_torch.parallel.mesh.pixel_set", "mesh"),
    # A replicated NamedSharding of the scene; every rank holds the whole
    # scene on the device of its Mesh.
    "raytpu.parallel.mesh.replicated": ("raytpu_torch.parallel.mesh.Mesh", "device"),
    "raytpu.render.DroppedRaysError": "raytpu_torch.render.DroppedRaysError",
    "raytpu.render.render_sharded": "raytpu_torch.render.render_sharded",
    "raytpu.render.render_single": "raytpu_torch.render.render_single",
    "raytpu.render.render_timed": "raytpu_torch.render.render_timed",
    "raytpu.render.resolve_backend": "raytpu_torch.render.resolve_backend",
    "raytpu.scene.Lights": "raytpu_torch.scene.Lights",
    "raytpu.scene.Medium": "raytpu_torch.scene.Medium",
    "raytpu.scene.Scene": "raytpu_torch.scene.Scene",
    "raytpu.scene.Spheres": "raytpu_torch.scene.Spheres",
    "raytpu.scene.build_scene": "raytpu_torch.scene.build_scene",
    "raytpu.scene.default_scene": "raytpu_torch.scene.default_scene",
    "raytpu.scene.make_material": "raytpu_torch.scene.make_material",
    "raytpu.scene.random_scene": "raytpu_torch.scene.random_scene",
    "raytpu.scene.single_sphere_scene": "raytpu_torch.scene.single_sphere_scene",
    "raytpu.scene_io.load_scene": "raytpu_torch.scene_io.load_scene",
    "raytpu.scene_io.save_scene": "raytpu_torch.scene_io.save_scene",
    "raytpu.scene_io.scene_from_dict": "raytpu_torch.scene_io.scene_from_dict",
    "raytpu.scene_io.scene_to_dict": "raytpu_torch.scene_io.scene_to_dict",
    "raytpu.trace.camera_rays": "raytpu_torch.trace.camera_rays",
    "raytpu.trace.render_image": "raytpu_torch.trace.render_image",
    "raytpu.trace.render_pixels": "raytpu_torch.trace.render_pixels",
    "raytpu.trace.trace_rays": "raytpu_torch.trace.trace_rays",
    "raytpu.utils.checkpoint.load_checkpoint": "raytpu_torch.utils.checkpoint.load_checkpoint",
    "raytpu.utils.checkpoint.save_checkpoint": "raytpu_torch.utils.checkpoint.save_checkpoint",
    "raytpu.utils.debug.checked_render": "raytpu_torch.utils.debug.checked_render",
    "raytpu.utils.profiling.Timer": "raytpu_torch.utils.profiling.Timer",
    "raytpu.utils.profiling.profile_trace": "raytpu_torch.utils.profiling.profile_trace",
    "raytpu.utils.profiling.scoped": "raytpu_torch.utils.profiling.scoped",
}


# raytpu's parameters the port's same-form counterparts leave out, and why.
DROPPED = {
    "interpret": "the Pallas interpreter: a kernel's wrapper runs its plain "
                 "version on a CPU tensor instead",
    "compact_mode": "raytpu's choice between its global and blocked "
                    "compaction sorts: the port has one compaction, K5",
    "ad": "the wavefront is differentiable whenever autograd records and a "
          "scene leaf requires grad",
}
# raytpu's parameters the port names otherwise: the port's pytree is a Scene.
RENAMED = {"pytree": "scene"}


def parameters(obj):
    """The names of obj's parameters, in order, without self, *args and
    **kwargs."""
    return [p.name for p in inspect.signature(obj).parameters.values()
            if p.name != "self"
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def public_names():
    """Every public top-level function and class a raytpu module defines,
    and bench.py's."""
    modules = [raytpu, bench] + [
        importlib.import_module(info.name)
        for info in pkgutil.walk_packages(raytpu.__path__, "raytpu.")]
    names = set()
    for module in modules:
        for name, obj in vars(module).items():
            if (not name.startswith("_") and callable(obj)
                    and not inspect.ismodule(obj)
                    and getattr(obj, "__module__", None) == module.__name__):
                names.add(f"{module.__name__}.{name}")
    return names


def resolve(path):
    """The object at a dotted path: the longest importable module prefix,
    then attributes."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(path)


def test_the_walk_finds_raytpus_surface():
    names = public_names()
    # Jitted and custom_vjp functions count, imported names do not.
    assert {"raytpu.trace.render_image", "raytpu.grad.loss_and_grad",
            "raytpu.kernels.trace_pallas.render_tiles_pallas_ad"} <= names
    assert "raytpu.scene.RenderConfig" not in names
    assert len(names) > 80


def test_every_public_name_has_a_row():
    names = public_names()
    missing = sorted(names - COUNTERPARTS.keys())
    assert not missing, f"public raytpu names without a counterpart: {missing}"
    stale = sorted(COUNTERPARTS.keys() - names)
    assert not stale, f"rows for names raytpu no longer has: {stale}"


def test_every_row_resolves_in_the_port():
    unresolved, no_argument = [], []
    for name, target in sorted(COUNTERPARTS.items()):
        path, argument = target if isinstance(target, tuple) else (target, None)
        assert path.startswith("raytpu_torch."), name
        try:
            obj = resolve(path)
        except (AttributeError, ModuleNotFoundError) as e:
            unresolved.append(f"{name} -> {path}: {e}")
            continue
        assert callable(obj), path
        if argument is not None and argument not in inspect.signature(obj).parameters:
            no_argument.append(f"{name} -> {path}({argument}=)")
    assert not unresolved, unresolved
    assert not no_argument, no_argument


def test_same_form_rows_take_raytpus_parameters_in_order():
    """raytpu's positional calls work on the port: each same-form row's
    parameters begin with raytpu's, in raytpu's order (DROPPED left out,
    RENAMED renamed), and the port adds its own only after them."""
    wrong = []
    for name, target in sorted(COUNTERPARTS.items()):
        if isinstance(target, tuple) or not callable(resolve(name)):
            continue
        try:
            want = parameters(resolve(name))
        except (TypeError, ValueError):  # no signature (an exception class)
            continue
        want = [RENAMED.get(p, p) for p in want if p not in DROPPED]
        got = parameters(resolve(target))
        if got[:len(want)] != want:
            wrong.append(f"{name}{tuple(want)} -> {target}{tuple(got)}")
    assert not wrong, wrong


def test_the_order_check_sees_a_fault():
    """The check above catches the two faults it was written for: the
    port's old render_timed (mesh eighth) and resolve_backend (device
    second) against raytpu's."""
    def old_render_timed(scene, cfg, warmup=1, iters=3, backend="auto",
                         wf_opts=None, on_drop="warn", mesh=None,
                         interleave=False):
        pass

    def old_resolve_backend(backend, device, scene=None, cfg=None):
        pass

    for name, old in (("raytpu.render.render_timed", old_render_timed),
                      ("raytpu.render.resolve_backend", old_resolve_backend)):
        want = parameters(resolve(name))
        assert parameters(old)[:len(want)] != want
        assert parameters(resolve(COUNTERPARTS[name]))[:len(want)] == want


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED, OTHER_FORM, NOT_PORTED = "ported", "another form", "not ported"
_TPU_STUDY = "a study of the TPU's compiler or units, with no counterpart on a card: "
_REFERENCE_PPMS = ("reads the reference renderer's own golden PPMs "
                   "(raytracer_gamma/testPPM*.ppm), which the repository does not "
                   "hold; it waits until they are committed")

# tools/<name>.py -> (PORTED, the port's module), (OTHER_FORM, a port path
# or file that carries its work, how), or (NOT_PORTED, None, why).
TOOL_PORTS = {
    "multiprocess_demo": (PORTED, "raytpu_torch.tools.multiprocess_demo"),
    "shard_balance": (PORTED, "raytpu_torch.tools.shard_balance"),
    # The benchmark's cells time the frames and fit steps of its configs
    # end to end, each with its trace's breakdown by kernel.
    "bench_all": (OTHER_FORM, "benchmark/run.py",
                  "the benchmark's frame and fit cells on the upstream scene, "
                  "config 5 and the SPD sphereflake, each path's kernels traced"),
    "step_bench": (OTHER_FORM, "benchmark/run.py",
                   "the fit cells' steps, with the host's and each kernel's "
                   "share of a step from the trace"),
    "wf_breakdown": (OTHER_FORM, "benchmark/trace.py",
                     "the wavefront cells' k3_ms, k4_ms and glue_ms and the "
                     "trace's breakdown of a step"),
    "bwd_bench": (OTHER_FORM, "benchmark/run.py",
                  "the fit cells' steps; K2 alone is chip_smoke.py phase 8's, "
                  "by CUDA events, which need no slope over a dispatch floor"),
    "chunk_profile": (OTHER_FORM, "raytpu_torch.utils.profiling.profile_trace",
                      "torch.profiler; chip_smoke.py phase 12 profiles a config-5 "
                      "frame with it"),
    "cull_sim": (OTHER_FORM, "raytpu_torch.kernels.culling",
                 "raytpu's masks function for function; chip_smoke.py phase 19 "
                 "measures their live share on config-5 chunk 0"),
    "device_time": (OTHER_FORM, "raytpu_torch.utils.profiling.Timer",
                    "CUDA events; chip_smoke.py phases 9 and 12 compute the bounds"),
    "train_frontier": (OTHER_FORM, "chip_smoke.py",
                       "phase 15's chunk sweep of the config-5 training step"),
    "wf_ablate": (OTHER_FORM, "chip_smoke.py",
                  "phase 12's live counts and K3/K5 times at every level of "
                  "config-5 chunk 0"),
    "wf_frontier": (OTHER_FORM, "chip_smoke.py",
                    "phase 12's chunk x capacity sweep of the config-5 frame"),
    "body_bench": (NOT_PORTED, None, _TPU_STUDY + "sphere-loop bodies in a Pallas kernel"),
    "glue_bench": (NOT_PORTED, None, _TPU_STUDY + "XLA sorts and gathers as wavefront glue"),
    "mosaic_repros": (NOT_PORTED, None, _TPU_STUDY + "Mosaic compiler failures"),
    "mxu_level_bench": (NOT_PORTED, None, _TPU_STUDY + "sphere tests on the MXU"),
    "overlap_study": (NOT_PORTED, None, _TPU_STUDY + "the psum in XLA's compiled schedule"),
    "permute_bench": (NOT_PORTED, None, _TPU_STUDY + "XLA's permutation primitives"),
    "scatter_bench": (NOT_PORTED, None, _TPU_STUDY + "the XLA scatter-add's cost"),
    "segsum_bench": (NOT_PORTED, None, _TPU_STUDY + "a segmented pre-reduction of XLA's scatter"),
    "probe_cond_f32_residuals": (NOT_PORTED, None, _TPU_STUDY + "a Mosaic legalization probe"),
    "probe_cursor_copy": (NOT_PORTED, None, _TPU_STUDY + "a Pallas grid pattern probe"),
    "probe_glue_crash": (NOT_PORTED, None, _TPU_STUDY + "a TPU worker crash bisection"),
    "probe_mosaic": (NOT_PORTED, None, _TPU_STUDY + "Mosaic feature probes"),
    "compact_ab": (NOT_PORTED, None,
                   "chooses raytpu's compact_mode, a TPU-only variant: the port "
                   "has one compaction, K5"),
    "step_device_ab": (NOT_PORTED, None,
                       "chooses RAYTPU_BWD_FULLTREE, raytpu's TPU-only backward "
                       "variants"),
    "regen_goldens": (NOT_PORTED, None,
                      "writes raytpu's goldens (tests/goldens), which the port is "
                      "held to and must not write"),
    "fit_golden": (NOT_PORTED, None, _REFERENCE_PPMS),
    "fit_golden2": (NOT_PORTED, None, _REFERENCE_PPMS),
    "fit_old_goldens": (NOT_PORTED, None, _REFERENCE_PPMS),
    "golden_full": (NOT_PORTED, None, _REFERENCE_PPMS),
    "diag_badpix": (NOT_PORTED, None, _REFERENCE_PPMS),
    "divsqrt_study": (NOT_PORTED, None, _REFERENCE_PPMS),
    "fma_study": (NOT_PORTED, None, _REFERENCE_PPMS),
}
# Ported tools whose flags are not raytpu's, and why.
OWN_FLAGS = {
    "multiprocess_demo": "one process a rank on torch.distributed: a file "
                         "rendezvous in place of --port, named suites in place "
                         "of --backend",
}


def tool_scripts():
    return sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "tools"))
                  if f.endswith(".py"))


def raytpu_flags(name):
    """{flag: default} of every add_argument call in tools/<name>.py."""
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            store_true = (isinstance(kw.get("action"), ast.Constant)
                          and kw["action"].value == "store_true")
            default = (eval(compile(ast.Expression(kw["default"]), name, "eval"), {})
                       if "default" in kw else (False if store_true else None))
            flags[node.args[0].value] = default
    return flags


def test_every_tool_script_has_an_entry():
    scripts = tool_scripts()
    assert len(scripts) == 34
    missing = sorted(set(scripts) - TOOL_PORTS.keys())
    assert not missing, f"tools/*.py without an entry: {missing}"
    stale = sorted(TOOL_PORTS.keys() - set(scripts))
    assert not stale, f"entries for scripts tools/ no longer has: {stale}"
    for name, entry in TOOL_PORTS.items():
        assert entry[0] in (PORTED, OTHER_FORM, NOT_PORTED), name
        if entry[0] == PORTED:
            assert callable(importlib.import_module(entry[1]).main), name
        elif entry[0] == OTHER_FORM:
            where = entry[1]
            if where.endswith(".py"):
                assert os.path.exists(os.path.join(ROOT, where)), name
            else:
                resolve(where)
            assert entry[2], name
        else:
            assert entry[1] is None and entry[2], name


def test_ported_tools_take_raytpus_flags():
    """Each ported tool's flags and defaults are raytpu's, plus --cpu."""
    for name, entry in sorted(TOOL_PORTS.items()):
        if entry[0] != PORTED or name in OWN_FLAGS:
            continue
        parser = importlib.import_module(entry[1]).build_parser()
        got = {a.option_strings[-1]: a.default for a in parser._actions
               if a.option_strings and a.option_strings[-1] != "--help"}
        want = {"--cpu": False, **raytpu_flags(name)}
        assert got == want, name
    assert set(OWN_FLAGS) <= {n for n, e in TOOL_PORTS.items() if e[0] == PORTED}
