"""Parameter database.

The reference (PISM) generates a NetCDF config database from
``src/pism_config.cdl`` (~600 typed, unit-tagged, documented parameters; every
one doubles as a CLI flag; read via ``src/util/ConfigInterface.cc``). We keep
PISM's parameter names and defaults so reference run scripts translate 1:1,
storing the database as a plain dict: ``name -> (value, units, doc)``.

``units=None`` marks strings/flags/integers. The set below covers the
parameters the implemented components read; extend alongside new components.
"""

# name: (default value, units, documentation)
PARAMETERS = {
    # --- physical constants -------------------------------------------------
    "constants.ice.density": (910.0, "kg m-3", "ice density"),
    "constants.ice.specific_heat_capacity": (2009.0, "J kg-1 K-1", "specific heat of ice"),
    "constants.ice.thermal_conductivity": (2.10, "W m-1 K-1", "thermal conductivity of cold ice"),
    "constants.ice.beta_Clausius_Clapeyron": (7.9e-8, "K Pa-1", "Clausius-Clapeyron constant"),
    "constants.fresh_water.density": (1000.0, "kg m-3", "fresh water density"),
    "constants.fresh_water.specific_heat_capacity": (4170.0, "J kg-1 K-1", "specific heat of water"),
    "constants.fresh_water.latent_heat_of_fusion": (3.34e5, "J kg-1", "latent heat of fusion"),
    "constants.fresh_water.melting_point_temperature": (273.15, "K", "melting point at 1 atm"),
    "constants.sea_water.density": (1028.0, "kg m-3", "sea water density"),
    "constants.sea_water.specific_heat_capacity": (3985.0, "J kg-1 K-1", "specific heat of sea water"),
    "constants.standard_gravity": (9.81, "m s-2", "acceleration due to gravity"),
    "constants.ideal_gas_constant": (8.31441, "J mol-1 K-1", "ideal gas constant"),

    # --- grid ---------------------------------------------------------------
    "grid.Mx": (61, None, "grid points in x"),
    "grid.My": (61, None, "grid points in y"),
    "grid.Mz": (31, None, "grid points in z (ice)"),
    "grid.Mbz": (1, None, "grid points in bedrock thermal layer"),
    "grid.Lx": (1500e3, "m", "half-width of domain in x"),
    "grid.Ly": (1500e3, "m", "half-width of domain in y"),
    "grid.Lz": (4000.0, "m", "height of computational domain"),
    "grid.Lbz": (0.0, "m", "thickness of bedrock thermal layer"),
    "grid.ice_vertical_spacing": ("quadratic", None, "equal | quadratic"),
    "grid.lambda": (4.0, None, "quadratic spacing refinement parameter"),
    "grid.periodicity": ("none", None, "none | x | y | xy"),
    "grid.Nx": (0, None, "device-mesh columns for spatial sharding (0 = auto factorization; the PETSc DMDA -Nx analog). Grid Mx must be divisible by it"),
    "grid.Ny": (0, None, "device-mesh rows for spatial sharding (0 = auto factorization; the PETSc DMDA -Ny analog). Grid My must be divisible by it"),
    "grid.registration": ("corner", None, "grid-point registration at bootstrap: corner (points at cell corners incl. +-L, dx = 2L/(M-1); this framework's historical default) | center (cell centers, dx = 2L/M; the reference's bootstrap default)"),
    "grid.projection": ("", None, "PROJ string of the grid mapping (e.g. +proj=stere +lat_0=90 +lat_ts=70 +lon_0=-45); stored as the proj attribute of output files, used to compute lat/lon"),

    # --- time stepping ------------------------------------------------------
    "time_stepping.adaptive_ratio": (0.12, None, "SIA diffusivity stability multiplier"),
    "time_stepping.resolution": (1.0, "seconds", "round the adaptive dt DOWN to a multiple of this (reference time_stepping.resolution: reproducible step sequences independent of floating-point noise in the limits); 0 = off"),
    "time_stepping.maximum_time_step": (60.0, "years", "maximum allowed dt"),
    "time_stepping.minimum_time_step": (1.0e-3, "seconds", "minimum allowed dt"),
    "time_stepping.cfl_factor": (1.0, None, "2D CFL multiplier for mass transport"),
    "time_stepping.hit_multiples": (0.0, "years", "if > 0, snap dt so model time hits integer multiples of this period (reference -timestep_hit_multiples)"),
    "time_stepping.skip.enabled": (False, None, "subcycle mass transport between energy steps"),
    "time_stepping.skip.max": (10, None, "max mass-transport substeps per energy step"),
    "time_stepping.skip.refresh_diffusivity": (True, None, "recompute the SIA diffusive flux from the evolving geometry on every skip substep (default). False = reference-parity skip semantics (the whole stress balance, including D, stays frozen across substeps) - measured to DESTABILIZE fine-grid margins in this discretization: at 16 km the frozen flux drives sustained margin flicker that collapses the adaptive dt (68 vs 4 steps/model-year, 6x throughput loss; docs/VALIDATION.md round-4 dt study). The recompute costs ~10 extra 2D z-integral stencils per mega-step and keeps the expensive SSA/energy updates skipped"),
    "time.calendar": ("365_day", None, "CF calendar"),

    # --- flow laws ----------------------------------------------------------
    "stress_balance.model": ("sia", None, "none|prescribed_sliding|sia|ssa|weertman_sliding|ssa+sia"),
    "stress_balance.sia.flow_law": ("gpbld", None, "flow law for SIA"),
    "stress_balance.sia.Glen_exponent": (3.0, None, "Glen exponent n (SIA)"),
    "stress_balance.sia.enhancement_factor": (1.0, None, "SIA enhancement factor"),
    "stress_balance.sia.surface_gradient_method": ("haseloff", None, "eta | haseloff | mahaffy"),
    "stress_balance.sia.bed_smoother.range": (5.0e3, "m", "Schoof bed smoother half-width (0 disables)"),
    "stress_balance.sia.limit_diffusivity": (False, None, "cap the SIA diffusivity (and, in this framework, the 3D SIA shear velocities' column flux) at stress_balance.sia.max_diffusivity instead of letting margin cliffs collapse the adaptive dt (reference SIAFD limit_diffusivity)"),
    "stress_balance.sia.pallas": ("auto", None, "fused Pallas SIA diffusivity+flux kernel: auto (TPU, f32, mahaffy, Paterson-Budd family) | on | off; with a device mesh the kernel runs per shard under shard_map with ppermute halos"),
    "stress_balance.sia.max_diffusivity": (100.0, "m2 s-1", "SIA diffusivity cap / sanity limit"),
    "stress_balance.ssa.flow_law": ("gpbld", None, "flow law for SSA"),
    "stress_balance.ssa.Glen_exponent": (3.0, None, "Glen exponent n (SSA)"),
    "stress_balance.ssa.enhancement_factor": (1.0, None, "SSA enhancement factor"),
    "stress_balance.ssa.epsilon": (1.0e13, "Pa s m", "nuH regularization added everywhere"),
    "stress_balance.ssa.strength_extension.constant_nu": (9.8687e14, "Pa s", "viscosity of strength extension"),
    "stress_balance.ssa.strength_extension.min_thickness": (50.0, "m", "thickness below which extension applies"),
    "stress_balance.ssa.method": ("fd", None, "fd (staggered FD + CFBC) | fem (Q1 Galerkin)"),
    "stress_balance.ssa.fd.relative_convergence": (1.0e-4, None, "[unimplemented] Picard rtol on nuH change"),
    "stress_balance.ssa.fd.max_iterations": (300, None, "max Picard iterations"),
    "stress_balance.ssa.fd.ksp_rtol": (1.0e-5, None, "inner Krylov relative tolerance (floor; the Eisenstat-Walker forcing loosens it adaptively up to ksp_rtol_max while the outer residual is far from converged)"),
    "stress_balance.ssa.fd.ksp_rtol_max": (0.3, None, "loosest adaptive inner tolerance (Eisenstat-Walker eta_max; set equal to ksp_rtol to disable inexact Newton; 0.3 measured fastest on the 5 km hybrid: a loose direction per sweep beats fewer, tighter sweeps)"),
    "stress_balance.ssa.fd.preconditioner": ("line", None, "inner-Krylov preconditioner: line (default: alternating-direction line relaxation — u along x, v along y — via batched parallel cyclic reduction; fully fused on TPU, ~2.4x Krylov iteration cut and ~1.6x SSA wall-time vs jacobi at 20 km Greenland scale) | jacobi (point diagonal) | mg (geometric multigrid V-cycle: beats jacobi on smooth high-contrast problems, but on warm production solves the V-cycle-preconditioned BiCGStab breaks down on near-noise-floor Newton systems — every late sweep burns the inner iteration cap and the solve exits on stagnation above tolerance; see docs/VALIDATION.md round-5 autopsy) | linemg (V(1,1) cycle with the line smoother: same breakdown at ~50 PCR solves per capped iteration — 35x slower than line at 5 km; diagnostic only)"),
    "stress_balance.ssa.fd.warmup_ksp_rtol": (1.0e-2, None, "inner Krylov tolerance for Picard warmup/safeguard sweeps (fixed-point sweeps do not need tight inner solves; 1e-2 cuts ~15% of the 5 km solve wall time over 1e-3 with no trajectory effect)"),
    "stress_balance.ssa.fd.ksp_max_it": (300, None, "inner Krylov max iterations"),
    "stress_balance.ssa.fd.nuH_iter_failure_underrelaxation": (0.8, None, "[unimplemented] under-relaxation on retry"),
    "stress_balance.ssa.fd.line_pcr_dtype": ("f32", None, "precision of the line-preconditioner tridiagonal solves: f32 (default) | bf16 (experimental; measured FASTER per step at 5 km but NOT robust — bf16 eliminations break the inner BiCGStab down on hard warm-start systems even with the signed pivot floor, and the 25-a trajectory shifted 5.4e-3 relative volume, 35x the measured chaotic envelope; see docs/VALIDATION.md round-5 study)"),
    "stress_balance.ssa.fd.line_pcr_impl": ("xla", None, "line-preconditioner tridiagonal backend: xla (shift-concat rounds) | pallas_sublane (fused single-VMEM-pass kernel, system axis on sublanes)"),
    "stress_balance.ssa.fd.line_block": (0, None, "block length of the line-preconditioner tridiagonal solves: 0 = exact whole-line solves; B > 0 solves independent B-cell blocks (fewer cyclic-reduction rounds, less HBM traffic per Krylov iteration, slightly weaker preconditioner)"),
    "stress_balance.ssa.fd.extrapolate_initial_guess": (False, None, "warm-start each production SSA solve from the time-extrapolated previous velocities u0 = u(-1) + (dt/dt(-1)) (u(-1) - u(-2)) instead of u(-1) (rebuild-native Newton-sweep saver; off = reference behavior)"),
    "stress_balance.ssa.fd.beta_floor": (10.0, "Pa s m-1", "tiny drag on all icy cells; regularizes isolated floating cells"),
    "stress_balance.ssa.fd.newton_rtol": (1.0e-7, None, "Newton convergence: |F| <= rtol |b|"),
    "stress_balance.ssa.fd.velocity_change_rtol": (1.0e-4, None, "hard stop when a sweep changes the velocity by less than this relative amount (matches the reference's ssafd_picard_rtol = 1e-4; 0 = run to the precision floor)"),
    "stress_balance.ssa.fd.pallas_matvec": ("auto", None, "fused Pallas Krylov matvec: auto (TPU, f32, non-periodic) | on | off"),
    "stress_balance.ssa.fd.solve_dtype": ("auto", None, "auto (default): float32 when the velocity-change stop is active (production; the per-sweep f64 residual costs ~1 ms at 5 km and leaves the iteration history identical), mixed when it is disabled (verification/inverse) | mixed (iterative refinement: f64 iterate + outer residual, f32 Krylov — velocities match float64 to ~1e-6) | float64 (full f64 solve island) | float32 (pure working-precision carry: no high-precision residual at all; residuals below ~3e-5 relative are unresolvable)"),
    "stress_balance.ssa.fd.newton_max_iterations": (100, None, "max Newton iterations"),
    "stress_balance.ssa.fd.picard_warmup": (5, None, "Picard iterations before Newton"),
    "stress_balance.ssa.fd.warmup_skip_rtol": (0.5, None, "skip the Picard warmup (drag-regularization continuation) when the initial residual is already below this fraction of |b| - a warm start from the previous step's velocity; the continuation's nearly-linear-drag first sweeps would move such an iterate AWAY from the solution (0 = never skip)"),
    "stress_balance.ssa.fd.eta_endgame_range": (16.0, None, "endgame tightening of the Eisenstat-Walker forcing: once |F| <= range * tol, set the inner tolerance to land at ~tol/2 in one sweep instead of contracting by eta_max per sweep through the noise-floor grind (the last 3-4 warm sweeps otherwise burn ~68% of the Krylov work at eta = 0.3); 0 disables. Default 16 measured at the 5 km north-star shape: 64 -> 59.5 ms/step reproducibly, trajectory shift 6e-5 relative volume = well inside the 2e-4 chaotic envelope; range 8 and 64 are both worse (docs/VALIDATION.md round-5 campaign)"),
    "stress_balance.ssa.fd.drag_jacobian": ("picard", None, "basal-drag linearization in the Newton sweeps: picard (default; frozen beta - robust at u -> 0 and 2x faster over full 5 km trajectories, where the exact direction triggers line-search/safeguard work on melt-season steps) | exact (d(beta u)/du; essential for drag-dominated streams like test N and fully-converged verification solves)"),
    "stress_balance.ssa.fd.max_speed": (50.0e3, "m year-1", "hard clamp on SSA speeds (guards CFL dt collapse)"),
    "stress_balance.ssa.fd.krylov_dot_dtype": ("auto", None, "accumulation dtype for Krylov/Newton dot products under f32 vectors: auto (default: float32 on the pure-f32 production path whose 3e-4 target sits far above the f32 dot noise - measured 5 km warm solve 56 -> 46 ms with unchanged iteration counts; float64 elsewhere) | float64 (emulated on TPU) | float32"),
    "stress_balance.ssa.fd.near_ksp_cap": (32, None, "Krylov iteration cap for Newton systems within 4x of the convergence target on the pure-f32 production path - near the f32 noise floor the system is noise and BiCGStab otherwise grinds to ksp_max_it (traced at 5 km: one 300-iteration breakdown sweep = 72% of a warm solve's Krylov work); ignored on float64/mixed/full-convergence solves"),
    "stress_balance.ssa.fd.safeguard_ksp_cap": (48, None, "Krylov iteration cap for Picard safeguard sweeps on the pure-f32 production path (frozen-coefficient systems solved to the loose warmup tolerance; more iterations on ill-posed noise only burn wall time); ignored on float64/mixed/full-convergence solves"),
    "stress_balance.ssa.fd.f32_production_rtol": (3.0e-4, None, "Newton residual target floor for the pure-f32 production carry (velocity-change stop active); the f32 residual floor is state-dependent (~1-2e-4 relative on margin-flicker states), so tighter targets grind noise (see docs/VALIDATION.md)"),
    "stress_balance.ssa.fd.mixed_production_rtol": (1.0e-4, None, "Newton residual target floor for the mixed (f64-carry) production solve when the velocity-change stop is active"),
    "stress_balance.blatter.metric_terms": (True, None, "sigma-coordinate chain-rule metric corrections in the Blatter membrane terms (vanish on flat base/uniform thickness)"),
    "time_stepping.max_steps_per_segment": (600, None, "max adaptive steps per device while_loop dispatch; bounds single-XLA-execution wall time (the TPU runtime watchdog kills multi-minute dispatches) - callers re-dispatch until t_end, so the trajectory is unchanged"),
    "stress_balance.ssa.Schoof_regularizing_velocity": (1.0, "m year-1", "SSA strain-rate regularization velocity"),
    "stress_balance.ssa.Schoof_regularizing_length": (1000.0, "km", "SSA strain-rate regularization length"),
    "stress_balance.calving_front_stress_bc": (True, None, "apply calving-front pressure BC"),
    "stress_balance.vertical_velocity_approximation": ("centered", None, "centered | upstream"),
    "stress_balance.weertman_sliding.k": (1.0e-11, "m s-1 Pa-1", "Weertman sliding coefficient (u = k tau^m / N^(m-1))"),
    "stress_balance.weertman_sliding.exponent": (3.0, None, "Weertman sliding exponent m"),
    "stress_balance.weertman_sliding.melt_only": (False, None, "slide only where the ice base is temperate (EISMINT II exp H)"),

    "flow_law.isothermal_Glen.ice_softness": (3.1689e-24, "Pa-3 s-1", "softness A for isothermal Glen"),
    "flow_law.Paterson_Budd.A_cold": (3.610e-13, "Pa-3 s-1", "Paterson-Budd cold prefactor"),
    "flow_law.Paterson_Budd.A_warm": (1.730e3, "Pa-3 s-1", "Paterson-Budd warm prefactor"),
    "flow_law.Paterson_Budd.Q_cold": (6.0e4, "J mol-1", "cold activation energy"),
    "flow_law.Paterson_Budd.Q_warm": (13.9e4, "J mol-1", "warm activation energy"),
    "flow_law.Paterson_Budd.T_critical": (263.15, "K", "cold/warm transition temperature"),
    "flow_law.gk.grain_size": (1.0e-3, "m", "Goldsby-Kohlstedt ice grain size"),
    "flow_law.gpbld.water_frac_coeff": (181.25, None, "GPBLD liquid-fraction softness coefficient"),
    "flow_law.gpbld.water_frac_observed_limit": (0.01, None, "cap on omega in GPBLD softness"),

    # --- basal resistance / yield stress ------------------------------------
    "basal_resistance.pseudo_plastic.enabled": (False, None, "pseudo-plastic sliding law"),
    "basal_resistance.regularized_coulomb.enabled": (False, None, "regularized-Coulomb sliding law (Zoet & Iverson 2020)"),
    "basal_resistance.regularized_coulomb.q": (0.2, None, "regularized-Coulomb exponent"),
    "basal_resistance.regularized_coulomb.u_threshold": (100.0, "m year-1", "regularized-Coulomb threshold velocity"),
    "basal_resistance.pseudo_plastic.q": (0.25, None, "pseudo-plastic exponent"),
    "basal_resistance.pseudo_plastic.u_threshold": (100.0, "m year-1", "threshold velocity"),
    "basal_resistance.plastic.regularization": (0.01, "m year-1", "plastic-law velocity regularization"),
    "basal_yield_stress.model": ("mohr_coulomb", None, "constant | mohr_coulomb | given"),
    "basal_yield_stress.given.file": ("", None, "file with the prescribed till yield stress (variable tauc) for -yield_stress given"),
    "basal_yield_stress.constant.value": (2.0e5, "Pa", "constant till yield stress"),
    "basal_yield_stress.ice_free_bedrock": (1.0e6, "Pa", "yield stress on ice-free bedrock"),
    "basal_yield_stress.mohr_coulomb.topg_to_phi.enabled": (False, None, "derive the till friction angle from bed elevation (linear ramp; the reference -topg_to_phi)"),
    "basal_yield_stress.mohr_coulomb.topg_to_phi.phi_min": (15.0, "degrees", "friction angle below topg_min (std-greenland example values)"),
    "basal_yield_stress.mohr_coulomb.topg_to_phi.phi_max": (45.0, "degrees", "friction angle above topg_max"),
    "basal_yield_stress.mohr_coulomb.topg_to_phi.topg_min": (-300.0, "m", "bed elevation of the weak-till end of the ramp"),
    "basal_yield_stress.mohr_coulomb.topg_to_phi.topg_max": (700.0, "m", "bed elevation of the strong-till end of the ramp"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.enabled": (False, None, "iteratively adjust the till friction angle toward a target surface elevation during grounded spin-up (reference -yield_stress ... tillphi_opt; Albrecht, Winkelmann & Levermann 2022)"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.dt": (100.0, "years", "time between tillphi optimization updates"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.dphi_scale": (0.01, "degrees m-1", "friction-angle change per meter of surface-elevation misfit"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.dphi_max": (2.0, "degrees", "maximum |friction-angle change| per update"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.phi_min": (2.0, "degrees", "lower bound of the optimized friction angle"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.phi_max": (70.0, "degrees", "upper bound of the optimized friction angle"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.dh_min": (1.0, "m", "dead band: |surface misfit| below this is not adjusted"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.file": ("", None, "file with the target surface elevation (variable usurf); empty = take the target from the initial state"),
    "basal_yield_stress.mohr_coulomb.till_phi_default": (30.0, "degrees", "default till friction angle"),
    "basal_yield_stress.mohr_coulomb.till_cohesion": (0.0, "Pa", "till cohesion"),
    "basal_yield_stress.mohr_coulomb.till_reference_effective_pressure": (1.0e5, "Pa", "N_0"),
    "basal_yield_stress.mohr_coulomb.till_reference_void_ratio": (0.69, None, "e_0"),
    "basal_yield_stress.mohr_coulomb.till_compressibility_coefficient": (0.12, None, "C_c"),
    "basal_yield_stress.mohr_coulomb.till_effective_fraction_overburden": (0.02, None, "delta"),

    # --- energy -------------------------------------------------------------
    "energy.model": ("enthalpy", None, "none | cold | enthalpy"),
    "energy.enthalpy.reference_temperature": (223.15, "K", "T_ref in E = c_i (T - T_ref)"),
    "energy.enthalpy.temperate_ice_thermal_conductivity_ratio": (0.1, None, "K_temperate/K_cold"),
    "energy.drainage_maximum_rate": (0.05, "year-1", "max temperate-ice drainage rate"),
    "energy.ch_warming.enabled": (False, None, "cryo-hydrologic warming (Phillips et al. 2010): parallel water-filled-crack enthalpy columns heat the ice"),
    "energy.ch_warming.average_channel_spacing": (20.0, "m", "average spacing R of the cryo-hydrologic cracks (heating ~ k (T_ch - T)/R^2)"),
    "energy.ch_warming.residual_water_fraction": (0.005, None, "water fraction of the flushed CH columns during the melt season"),
    "energy.drainage_target_water_fraction": (0.01, None, "drain liquid fraction above this"),
    "energy.minimum_allowed_temperature": (200.0, "K", "sanity floor for ice temperature"),
    "energy.margin_ice_thickness_limit": (100.0, "m", "[unimplemented] margin-column treatment threshold"),
    "energy.bedrock_thermal.density": (3300.0, "kg m-3", "bedrock density"),
    "energy.bedrock_thermal.conductivity": (3.0, "W m-1 K-1", "bedrock thermal conductivity"),
    "energy.bedrock_thermal.specific_heat_capacity": (1000.0, "J kg-1 K-1", "bedrock specific heat"),
    "energy.basal_melt.use_grounded_cell_fraction": (True, None, "scale basal melt by grounded fraction"),

    # --- age ------------------------------------------------------------------
    "age.enabled": (False, None, "transport 3D ice age"),
    "age.initial_value": (0.0, "years", "initial age"),
    "age.isochrones.enabled": (False, None, "trace isochrone deposition layers"),
    "age.isochrones.n_layers": (16, None, "static layer-array size"),
    "age.isochrones.deposition_times": ("", None, "years: 'a:step:b' or comma list"),

    # --- geometry / mass transport ------------------------------------------
    "geometry.ice_free_thickness_standard": (0.01, "m", "H below this means ice-free"),
    "geometry.update.enabled": (True, None, "evolve ice geometry"),
    "geometry.part_grid.enabled": (False, None, "Albrecht part-grid front advance"),
    "geometry.grounded_cell_fraction": (True, None, "sub-grid grounding line interpolation (Feldmann et al. 2014 friction scaling); examples/mismip_study.py: without it the 25 km MISMIP grounding line over-advances to the domain edge (+448 km), with it the error is -45 km vs the Schoof semi-analytic position"),

    # --- hydrology ----------------------------------------------------------
    "hydrology.model": ("null", None, "null | routing | distributed | steady"),
    "hydrology.steady_max_iterations": (4096, None, "iteration cap of the steady flow-accumulation fixed point (bounds the longest resolvable flow path)"),
    "hydrology.tillwat_max": (2.0, "m", "maximum till water thickness"),
    "hydrology.tillwat_decay_rate": (1.0, "m year-1", "till water decay rate C"),
    "hydrology.hydraulic_conductivity": (1.0e-2, None, "routing conductivity k"),
    "hydrology.alpha": (1.25, None, "routing flux exponent on W"),
    "hydrology.beta": (1.5, None, "routing flux exponent on |grad psi|"),
    "hydrology.thickness_power_in_flux": (1.25, None, "routing flux exponent on W (reference name; hydrology.alpha is the short alias)"),
    "hydrology.gradient_power_in_flux": (1.5, None, "routing flux exponent on |grad psi| (reference name; hydrology.beta is the short alias)"),
    "hydrology.regularizing_porosity": (0.01, None, "distributed-model regularizing porosity"),
    "hydrology.roughness_scale": (0.1, "m", "distributed-model bed roughness W_r"),
    "hydrology.cavitation_opening_coefficient": (0.5, "m-1", "c_1"),
    "hydrology.creep_closure_coefficient": (0.04, None, "c_2"),
    "hydrology.maximum_time_step": (0.0, "years", "hydrology dt cap (<= 0 = disabled; the rebuild CFL-subcycles routing internally, so unlike the reference no cap is needed by default)"),

    # --- calving / front retreat --------------------------------------------
    "calving.methods": ("", None, "comma list: eigen_calving,thickness_calving,vonmises_calving,float_kill"),
    "calving.eigen_calving.K": (0.0, "m s", "eigencalving proportionality constant"),
    "calving.vonmises_calving.sigma_max": (1.0e6, "Pa", "von Mises yield stress"),
    "calving.hayhurst_calving.B_tilde": (65.0, None, "Hayhurst rate factor [MPa^-r year-1] (Mercenier et al. 2018)"),
    "calving.hayhurst_calving.exponent_r": (0.43, None, "Hayhurst stress exponent"),
    "calving.hayhurst_calving.sigma_threshold": (1.7e5, "Pa", "Hayhurst tensile stress threshold"),
    "calving.thickness_calving.threshold": (50.0, "m", "calve ice thinner than this"),
    "calving.float_kill.enabled": (False, None, "remove all floating ice"),
    "calving.front_retreat.use_cfl": (False, None, "restrict dt by retreat-rate CFL"),
    "frontal_melt.models": ("", None, "frontal melt model: constant | given | routing"),
    "frontal_melt.constant.melt_rate": (0.0, "m year-1", "constant frontal melt rate"),
    "frontal_melt.include_floating_ice": (False, None, "apply frontal melt to floating fronts too"),
    "geometry.remove_icebergs": (False, None, "drop shelves not connected to grounded ice"),

    # --- fracture density ------------------------------------------------------
    "fracture_density.enabled": (False, None, "evolve the fracture phase field"),
    "fracture_density.gamma": (1.0, None, "fracture growth rate factor"),
    "fracture_density.initiation_threshold": (7.0e-10, "s-1", "strain rate above which fractures form"),
    "fracture_density.gamma_h": (0.0, None, "fracture healing rate factor"),
    "fracture_density.healing_threshold": (2.0e-10, "s-1", "strain rate below which fractures heal"),
    "fracture_density.softening_lower_limit": (1.0, None, "1 = no rheology softening feedback"),

    # --- regional mode ----------------------------------------------------------
    "regional.enabled": (False, None, "outlet-glacier subdomain mode (no_model_mask)"),
    "regional.no_model_yield_stress": (1.0e6, "Pa", "yield stress applied inside the no-model strip (RegionalYieldStress)"),

    # --- bed deformation -----------------------------------------------------
    "bed_deformation.model": ("none", None, "none | iso | lc | given"),
    "bed_deformation.update_interval": (10.0, "years", "how often to update the bed"),
    "bed_deformation.lc.grid_size_factor": (2, None, "FFT grid extension factor"),
    "bed_deformation.lc.elastic_model": (False, None, "include elastic plate response"),
    "bed_deformation.lithosphere_flexural_rigidity": (5.0e24, "N m", "flexural rigidity D"),
    "bed_deformation.mantle_viscosity": (1.0e21, "Pa s", "half-space mantle viscosity"),
    "bed_deformation.bed_uplift_file": ("", None, "initialize the Lingle-Clark viscous displacement from this observed-uplift file (variable dbdt; the reference -uplift_file)"),
    "bed_deformation.mantle_density": (3300.0, "kg m-3", "mantle density"),
    "bed_deformation.given.file": ("", None, "file with the prescribed topg_delta time stack (-bed_def given)"),
    "bed_deformation.given.reference_file": ("", None, "file with the reference topg for -bed_def given (default: bed at initialization)"),
    "bed_deformation.lithosphere_density": (3300.0, "kg m-3", "lithosphere density (pointwise isostasy)"),

    # --- couplers -----------------------------------------------------------
    "atmosphere.models": ("uniform", None, "comma-separated atmosphere model chain"),
    "atmosphere.given.file": ("", None, "NetCDF file with air_temp/precipitation (2D or time stacks) for -atmosphere given"),
    "atmosphere.delta_T.file": ("", None, "scalar delta_T time-series file for the delta_T atmosphere modifier"),
    "atmosphere.frac_P.file": ("", None, "scalar frac_P time-series file for the frac_P modifier"),
    "atmosphere.precip_scaling.file": ("", None, "scalar delta_T series file for the precip_scaling modifier"),
    "atmosphere.uniform.temperature": (263.15, "K", "uniform air temperature"),
    "atmosphere.uniform.precipitation": (0.0, "kg m-2 year-1", "uniform precipitation"),
    "atmosphere.pik.parameterization": ("martin", None, "martin (mean-annual only) | martin_huybrechts_dewolde (adds the Huybrechts & de Wolde 1999 summer temperature)"),
    "atmosphere.given.period": (0.0, "years", "if > 0, cycle the -atmosphere given time series with this period (e.g. 1 for a monthly climatology)"),
    "atmosphere.elevation_change.temperature_lapse_rate": (6.0e-3, "K m-1", "lapse-rate modifier temperature lapse rate"),
    "atmosphere.elevation_change.precipitation.lapse_rate": (0.0, "m s-1 m-1", "precipitation shift per meter of surface uplift (elevation_change shift method; ice equivalent)"),
    "atmosphere.elevation_change.precipitation.method": ("scale", None, "scale (exponential in the implied dT) | shift (linear lapse)"),
    "surface.elevation_change.temperature_lapse_rate": (6.0e-3, "K m-1", "surface elevation_change modifier temperature lapse rate"),
    "surface.elevation_change.smb.lapse_rate": (0.0, "m s-1 m-1", "SMB shift per meter of surface uplift (smb.method=shift; ice equivalent)"),
    "surface.elevation_change.smb.exp_factor": (0.0, "K-1", "SMB exponential scaling per K of implied temperature change (smb.method=scale)"),
    "surface.elevation_change.smb.method": ("shift", None, "shift | scale"),
    "atmosphere.precip_exponential_factor_for_temperature": (0.07042, "K-1", "precip_scaling exponential factor (Huybrechts & de Wolde 1999)"),
    "atmosphere.orographic_precipitation.wind_speed": (15.0, "m s-1", "LTOP background wind speed"),
    "atmosphere.orographic_precipitation.wind_direction": (270.0, "degrees", "direction the wind blows FROM (meteorological; 270 = westerly)"),
    "atmosphere.orographic_precipitation.conversion_time": (1000.0, "seconds", "LTOP cloud-water conversion time tau_c"),
    "atmosphere.orographic_precipitation.fallout_time": (1000.0, "seconds", "LTOP hydrometeor fallout time tau_f"),
    "atmosphere.orographic_precipitation.water_vapor_scale_height": (2500.0, "m", "LTOP water vapor scale height H_w"),
    "atmosphere.orographic_precipitation.moist_stability_frequency": (0.005, "s-1", "LTOP moist buoyancy frequency N_m"),
    "atmosphere.orographic_precipitation.uplift_sensitivity": (0.001, "kg m-3", "LTOP uplift sensitivity C_w"),
    "atmosphere.orographic_precipitation.background_precip_rate": (9.51e-9, "m s-1", "precipitation floor added to the LTOP anomaly (~0.3 m/a)"),
    "surface.models": ("simple", None, "comma-separated surface model chain"),
    "surface.given.file": ("", None, "NetCDF file with climatic_mass_balance/ice_surface_temp (2D or time stacks) for -surface given"),
    "surface.given.period": (0.0, "years", "if > 0, cycle the -surface given time series with this period"),
    "surface.delta_T.file": ("", None, "scalar delta_T series file for the surface delta_T modifier"),
    "surface.elevation_dependent.z_min": (1100.0, "m", "elevation surface model: SMB ramp bottom"),
    "surface.elevation_dependent.z_ela": (1450.0, "m", "elevation surface model: equilibrium line altitude"),
    "surface.elevation_dependent.z_max": (1700.0, "m", "elevation surface model: SMB ramp top"),
    "surface.elevation_dependent.m_min": (-3.0, "m year-1", "elevation surface model: SMB at z_min"),
    "surface.elevation_dependent.m_max": (4.0, "m year-1", "elevation surface model: SMB at z_max"),
    "surface.cache.update_interval": (10.0, "years", "cache modifier update interval"),
    "surface.force_to_thickness.alpha": (3.17e-9, "s-1", "force_to_thickness nudging coefficient"),
    "ocean.cache.update_interval": (10.0, "years", "ocean cache modifier update interval"),
    "surface.pdd.factor_snow": (3.04e-3, "m K-1 day-1", "PDD melt factor for snow (ice equivalent)"),
    "surface.pdd.factor_ice": (8.79e-3, "m K-1 day-1", "PDD melt factor for ice"),
    "surface.pdd.refreeze": (0.6, None, "refreeze fraction"),
    "surface.pdd.std_dev.value": (5.0, "K", "std dev of daily temperature variability"),
    "surface.pdd.std_dev.param_a": (-0.15, "K K-1", "slope of the linear sigma(T) parameterization (Seguinot 2013)"),
    "surface.pdd.std_dev.param_b": (0.66, "K", "intercept of the linear sigma(T) parameterization at 273.15 K"),
    "surface.pdd.std_dev.param_enabled": (False, None, "parameterize the PDD sigma as a linear function of air temperature"),
    "surface.pdd.std_dev.file": ("", None, "read the 2D air_temp_sd field from this file (overrides the scalar/parameterized sigma)"),
    "surface.pdd.positive_threshold_temp": (273.15, "K", "temperature above which melt occurs"),
    "surface.pdd.air_temp_all_precip_as_snow": (272.15, "K", "below: all precip is snow"),
    "surface.pdd.air_temp_all_precip_as_rain": (274.15, "K", "above: all precip is rain"),
    "surface.pdd.refreeze_ice_melt": (False, None, "also refreeze the refreeze fraction of ice melt"),
    "surface.pdd.balance_year_start_day": (274.0, None, "day of year the mass-balance year starts (snow resets, surviving snow becomes firn)"),
    "surface.pdd.method": ("expectation_integral", None, "PDD computation: expectation_integral (Calov-Greve), random_process (Monte-Carlo daily temperature draws), repeatable_random_process (fixed seed)"),
    # dEBM-simple (PISM surface::DEBMSimple, Zeitz et al. 2021)
    "surface.debm_simple.albedo_max": (0.82, None, "dEBM: fresh-snow (maximum) albedo"),
    "surface.debm_simple.albedo_min": (0.47, None, "dEBM: bare-ice (minimum) albedo"),
    "surface.debm_simple.albedo_slope": (-790.0, "m2 s kg-1", "dEBM: albedo change per unit melt mass flux (melt-albedo feedback)"),
    "surface.debm_simple.c1": (29.0, "W m-2 K-1", "dEBM: temperature-driven melt coefficient"),
    "surface.debm_simple.c2": (-93.0, "W m-2", "dEBM: background (longwave-loss) melt offset"),
    "surface.debm_simple.melting_threshold_temp": (266.65, "K", "dEBM: no melt below this air temperature"),
    "surface.debm_simple.positive_threshold_temp": (273.15, "K", "dEBM: reference temperature of the effective-temperature integral"),
    "surface.debm_simple.phi": (17.5, "degrees", "dEBM: minimum sun elevation angle of the diurnal melt period"),
    "surface.debm_simple.solar_constant": (1361.0, "W m-2", "dEBM: solar constant"),
    "surface.debm_simple.std_dev": (5.0, "K", "dEBM: std dev of daily temperature variability"),
    "surface.debm_simple.std_dev.param_a": (-0.15, "K K-1", "dEBM: slope of the linear sigma(T) parameterization"),
    "surface.debm_simple.std_dev.param_b": (0.66, "K", "dEBM: intercept of the linear sigma(T) parameterization (at 273.15 K)"),
    "surface.debm_simple.std_dev.param_enabled": (False, None, "dEBM: parameterize sigma as a linear function of air temperature"),
    "surface.debm_simple.tau_a_intercept": (0.65, None, "dEBM: atmospheric transmissivity at sea level"),
    "surface.debm_simple.tau_a_slope": (0.000032, "m-1", "dEBM: transmissivity increase per meter of surface elevation"),
    "surface.debm_simple.paleo.enabled": (False, None, "dEBM: compute insolation from orbital parameters (Berger 1978) instead of present-day expansions"),
    "surface.debm_simple.paleo.file": ("", None, "dEBM paleo: scalar time-series file with eccentricity/obliquity/perihelion_longitude (degrees)"),
    "surface.debm_simple.albedo_input.file": ("", None, "dEBM: prescribe the albedo from this file (variable albedo) instead of the melt parameterization"),
    "surface.debm_simple.paleo.eccentricity": (0.0167, None, "dEBM paleo: orbital eccentricity"),
    "surface.debm_simple.paleo.obliquity": (23.44, "degrees", "dEBM paleo: axial tilt"),
    "surface.debm_simple.paleo.perihelion_longitude": (102.94719, "degrees", "dEBM paleo: longitude of perihelion"),
    "surface.debm_simple.refreeze": (0.6, None, "dEBM: refreeze fraction of snow melt"),
    "surface.debm_simple.refreeze_ice_melt": (False, None, "dEBM: also refreeze the refreeze fraction of ice melt"),
    "surface.debm_simple.interpret_precip_as_snow": (False, None, "dEBM: treat all precipitation as snow regardless of air temperature"),
    "surface.debm_simple.air_temp_all_precip_as_snow": (273.15, "K", "dEBM: below this all precip is snow"),
    "surface.debm_simple.air_temp_all_precip_as_rain": (275.15, "K", "dEBM: above this all precip is rain"),
    "ocean.models": ("constant", None, "comma-separated ocean model chain"),
    "ocean.given.file": ("", None, "NetCDF file with shelf_base_mass_flux [, shelf_base_temperature] for -ocean given"),
    "ocean.th.file": ("", None, "NetCDF file with theta_ocean/salinity_ocean for -ocean th"),
    "ocean.th.period": (0.0, "years", "if > 0, cycle the -ocean th time series with this period"),
    "ocean.delta_T.file": ("", None, "scalar delta_T series file for the ocean delta_T modifier"),
    "ocean.frac_MBP.file": ("", None, "scalar melange back-pressure fraction series file for frac_MBP"),
    "ocean.delta_MBP.file": ("", None, "scalar melange back-pressure offset [Pa] series file for delta_MBP"),
    "ocean.constant.melt_rate": (0.0, "m year-1", "constant sub-shelf melt rate (ice equivalent)"),
    "ocean.sub_shelf_heat_flux_into_ice": (0.5, "W m-2", "heat flux into shelf base"),
    "ocean.pik_melt_factor": (5.0e-3, None, "PIK depth-dependent melt factor"),
    "ocean.th.gamma_T": (1.00e-4, "m s-1", "GivenTH turbulent heat exchange coefficient"),
    "ocean.th.gamma_S": (5.05e-7, "m s-1", "GivenTH turbulent salt exchange coefficient"),
    "ocean.th.ice_temperature": (265.15, "K", "GivenTH shelf-ice interior temperature for the heat-conduction term"),
    "ocean.th.two_equation": (False, None, "GivenTH: drop the salt equation (fixed S_b = S_o) instead of the full 3-equation solve"),
    "ocean.pico.number_of_boxes": (5, None, "PICO box count"),
    "ocean.pico.heat_exchange_coefficent": (1.0e-5, "m s-1", "PICO gamma_T*"),
    "ocean.pico.overturning_coefficent": (1.0e6, "m6 s-1 kg-1", "PICO overturning C"),
    "ocean.pico.continental_shelf_depth": (-800.0, "m", "PICO continental shelf depth"),
    "sea_level.models": ("constant", None, "sea level model chain"),
    "sea_level.delta_sl.file": ("", None, "scalar delta_SL series file for the delta_sl modifier"),
    "sea_level.constant.value": (0.0, "m", "constant sea level"),

    # --- bootstrapping -------------------------------------------------------
    "bootstrapping.defaults.geothermal_flux": (0.042, "W m-2", "default geothermal flux"),
    "bootstrapping.defaults.ice_surface_temp": (263.15, "K", "default surface temperature"),

    # --- output / runtime ----------------------------------------------------
    "runtime.verbosity": (2, None, "logging verbosity (PISM levels: 1 warnings, 2 summaries, 3 component detail, 4 solver detail, 5 trace)"),
    "runtime.matmul_precision": ("highest", None, "jax default_matmul_precision for the f32 compute path: highest (f32 accumulate; required - bf16 MXU passes lose the SSA residual) | high | default"),
    "runtime.float_dtype": ("float64", None, "float32 | float64: dtype of model fields"),
    "runtime.segment_years": (50.0, "years", "max model-years per jitted while_loop segment"),
    "runtime.device_loop": (True, None, "run segments as on-device while_loops; False = host-dispatched steps (workaround for TPU runtimes that mishandle long nested while_loops)"),
    "output.ice_free_thickness_standard": (0.01, "m", "reporting ice-free threshold"),
    "run_info.institution": ("", None, "institution attribute for output files"),
    "run_info.title": ("", None, "title attribute for output files"),
}

# ---------------------------------------------------------------------------
# Second tranche toward full ``src/pism_config.cdl`` parity (upstream names
# kept verbatim so reference run scripts translate 1:1). Parameters for
# features with a different TPU-native realization are still registered —
# the reference treats the CDL as the single source of CLI flags and
# documentation, and so do we.
# ---------------------------------------------------------------------------

PARAMETERS.update({
    # --- time ----------------------------------------------------------------
    "time.start": (0.0, "years", "run start time (-ys)"),
    "time.end": (0.0, "years", "run end time (-ye; 0 = use time.run_length)"),
    "time.run_length": (1000.0, "years", "run duration when time.end is unset (-y)"),
    "time.reference_date": ("1-1-1", None, "CF reference date of the time axis"),
    "time.eemian_start": (-132500.0, "years", "start of the Eemian interglacial (paleo run helpers)"),
    "time.eemian_end": (-114500.0, "years", "end of the Eemian interglacial"),
    "time.holocene_start": (-11700.0, "years", "start of the Holocene"),

    # --- time stepping -------------------------------------------------------
    "time_stepping.dt_force": (-1.0, "years", "override the adaptive dt with a fixed value (< 0 = adaptive)"),
    "time_stepping.adaptive_timestepping": (True, None, "use adaptive time stepping"),
    "time_stepping.resolution": (1.0, "seconds", "quantize dt to multiples of this (reproducible restarts)"),
    "time_stepping.assume_bed_elevation_changed": (False, None, "[n/a in this architecture: every dt limit is recomputed every step] recompute diffusivity-based dt bounds even when the bed is static"),

    # --- grid ----------------------------------------------------------------
    "grid.allow_extrapolation": (False, None, "allow bootstrapping fields that do not cover the domain"),
    "grid.correct_cell_areas": (True, None, "[unimplemented] correct cell areas using the projection (lat/lon grids)"),
    "grid.recompute_longitude_and_latitude": (True, None, "recompute lat/lon from the projection instead of reading them"),
    "grid.max_stencil_width": (2, None, "[n/a in this architecture: XLA GSPMD manages halo widths] widest stencil of any component (ghost width)"),

    # --- input / regridding ---------------------------------------------------
    "input.file": ("", None, "input (restart or bootstrap) file (-i)"),
    "input.bootstrap": (False, None, "bootstrap from incomplete fields (-bootstrap)"),
    "input.forcing.buffer_size": (60, None, "frames of time-dependent forcing kept in memory (streamed reads)"),
    "input.forcing.time_extrapolation": (False, None, "hold forcing constant outside the covered interval instead of stopping"),
    "input.regrid.file": ("", None, "file to regrid fields from over the input state (-regrid_file)"),
    "input.regrid.vars": ("", None, "comma list of variables to regrid (-regrid_vars)"),

    # --- output ----------------------------------------------------------------
    "output.file": ("unnamed.nc", None, "output file name (-o)"),
    "output.format": ("netcdf4", None, "netcdf4 | netcdf3: on-disk format (-o_format)"),
    "output.extra.stop_missing": (True, None, "error on unknown -extra_vars entries (reference output.extra.stop_missing); false drops them with a warning"),
    "time_stepping.count_time_steps": (False, None, "log the total number of adaptive steps at the end of the run (reference -count_time_steps)"),
    "surface.debm_simple.albedo_ocean": (0.1, None, "albedo of ice-free (ocean) cells in the dEBM-simple insolation melt"),
    "runtime.tridiag.thomas_max_n": (64, None, "batched-tridiagonal dispatch: systems up to this length always use the Thomas scan on TPU (measured crossover, one v5e; see util/tridiag.py)"),
    "runtime.tridiag.thomas_min_batch": (16384, None, "batched-tridiagonal dispatch: batches at least this wide use the Thomas scan regardless of length (each scan step saturates the VPU)"),
    "output.sizes.medium": ("velsurf_mag velbase_mag velbar_mag taud_mag tauc bmelt tillwat temppabase diffusivity climatic_mass_balance ice_surface_temp sftgif sftgrf sftflf flux_mag", None, "diagnostics appended to the output file with -o_size medium (reference output.sizes.medium)"),
    "output.sizes.big_2d": ("velsurf velbase wvelsurf flux_divergence dHdt surface_runoff_flux", None, "extra 2D fields for -o_size big_2d (reference output.sizes.big_2d)"),
    "output.sizes.big": ("temp temppa liqfrac uvel vvel wvel_rel strainheating", None, "extra 3D fields for -o_size big, on top of medium + big_2d (reference output.sizes.big)"),
    "output.size": ("medium", None, "none | small | medium | big: which variable set -o writes (-o_size)"),
    "output.compression_level": (0, None, "deflate level of NetCDF-4 output variables"),
    "output.extra.file": ("", None, "spatial time-series file (-extra_file)"),
    "output.extra.times": ("", None, "times of -extra_file records (-extra_times)"),
    "output.extra.vars": ("", None, "comma list of diagnostics written to -extra_file (-extra_vars)"),
    "output.extra.split": (False, None, "[unimplemented] write each -extra record to its own file (-extra_split)"),
    "output.extra.append": (False, None, "[unimplemented] append to an existing -extra_file"),
    "output.timeseries.filename": ("", None, "scalar time-series file (-ts_file)"),
    "output.timeseries.times": ("", None, "times of -ts_file records (-ts_times)"),
    "output.timeseries.append": (False, None, "[unimplemented] append to an existing -ts_file"),
    "output.timeseries.buffer_size": (10000, None, "[unimplemented] scalar samples buffered between flushes"),
    "output.snapshot.file": ("", None, "snapshot file prefix (-save_file)"),
    "output.snapshot.times": ("", None, "snapshot times (-save_times)"),
    "output.snapshot.split": (True, None, "[unimplemented] one file per snapshot (-save_split)"),
    "output.snapshot.size": ("small", None, "variable set written to snapshots (-save_size)"),
    "output.backup_interval": (0.0, "hours", "wall-clock interval between backups (0 = off)"),
    "output.backup_size": ("small", None, "[unimplemented] variable set written to backups"),
    "output.checkpoint.interval": (0.0, "hours", "alias of output.backup_interval"),
    "output.runtime.volume_scale_factor_log10": (0, None, "ice volume in runtime summaries is scaled by 10^this"),
    "output.runtime.area_scale_factor_log10": (0, None, "ice area in runtime summaries is scaled by 10^this"),
    "output.runtime.time_unit_name": ("year", None, "time unit of runtime summaries"),
    "output.runtime.time_use_calendar": (True, None, "print calendar dates in runtime summaries"),
    "output.fill_value": (-2.0e9, None, "_FillValue of output variables"),
    "output.use_MKS": (False, None, "[unimplemented] write output in MKS units instead of glaciological units"),
    "output.ISMIP6": (False, None, "[unimplemented] write ISMIP6 (CMIP) variable names and units"),
    "output.ISMIP6_extra_variables": ("", None, "[unimplemented] extra ISMIP6 variables to report"),

    # --- stress balance: SIA extras -------------------------------------------
    "stress_balance.sia.bed_smoother.theta_min": (0.0, None, "floor of the Schoof bed-roughness flux multiplier theta"),
    "stress_balance.sia.e_age_coupling": (False, None, "couple the SIA enhancement factor to ice age (EDC/EemianGreenland runs)"),
    "stress_balance.sia.grain_size_age_coupling": (False, None, "[unimplemented] compute the Goldsby-Kohlstedt grain size from ice age"),
    "stress_balance.sia.max_diffusivity_allow_unlimited": (False, None, "warn instead of stopping when the diffusivity exceeds max_diffusivity"),

    # --- stress balance: SSA extras --------------------------------------------
    "stress_balance.ssa.fd.lateral_drag.enabled": (False, None, "add lateral drag along ice-free-bedrock margins (fjord walls)"),
    "stress_balance.ssa.fd.lateral_drag.viscosity": (5.0e15, "Pa s", "nuH used for the lateral-drag boundary"),
    "stress_balance.ssa.fd.flow_line_mode": (False, None, "[unimplemented] 1D flow-line mode: zero all y-derivatives in the SSA system"),
    "stress_balance.ssa.fd.replace_zero_diagonal_entries": (True, None, "[n/a in this architecture: the matrix-free operator has no assembled diagonal; isolated cells are regularized by fd.beta_floor] regularize zero diagonal entries in the SSA system (ice-free cells)"),
    "stress_balance.ssa.fd.extrapolate_at_margins": (True, None, "[unimplemented] extrapolate the SSA velocity one cell past the ice margin for the transport stencil"),
    "stress_balance.ssa.compute_surface_gradient_inward": (False, None, "[unimplemented] one-sided surface-gradient differences at the domain edge"),
    "stress_balance.ssa.dirichlet_bc": (False, None, "respect the vel_bc_mask/u_bc/v_bc Dirichlet velocities"),
    "stress_balance.ssa.read_initial_guess": (True, None, "warm-start the SSA from the velocities in the input file"),

    # --- stress balance: Blatter -----------------------------------------------
    "stress_balance.blatter.Mz": (17, None, "[n/a in this architecture: the Blatter solver shares the ice grid's vertical levels (grid.Mz)] vertical levels of the Blatter sigma grid"),
    "stress_balance.blatter.coarsening_factor": (2, None, "[n/a in this architecture: the batched vertical-line preconditioner replaces the reference's vertical-semicoarsening multigrid] vertical semi-coarsening factor of the reference's multigrid (the rebuild's vertical-line preconditioner role)"),
    "stress_balance.blatter.flow_law": ("gpbld", None, "flow law of the Blatter solver"),
    "stress_balance.blatter.enhancement_factor": (1.0, None, "Blatter enhancement factor"),
    "stress_balance.blatter.use_eta_transform": (True, None, "[unimplemented] eta-transform of the surface gradient near margins"),
    "stress_balance.blatter.newton_max_iterations": (50, None, "Blatter Newton iteration cap"),
    "stress_balance.blatter.newton_rtol": (1.0e-7, None, "Blatter Newton relative tolerance"),

    # --- basal resistance extras ------------------------------------------------
    "basal_resistance.beta_ice_free_bedrock": (1.8e9, "Pa s m-1", "[n/a in this architecture: ice-free cells are Dirichlet rows (u = 0), which is infinitely strong] drag coefficient on ice-free bedrock (grounded margins)"),
    "basal_resistance.beta_lateral_margin": (0.0, "Pa s m-1", "extra drag at lateral margins (0 = off)"),
    "basal_resistance.pseudo_plastic.sliding_scale_factor": (-1.0, None, "scale sliding speeds by this factor (< 0 = off; SeaRISE experiment knob)"),

    # --- basal yield stress extras ----------------------------------------------
    "basal_yield_stress.add_transportable_water": (False, None, "effective pressure sees routing water in addition to till water"),
    "basal_yield_stress.slippery_grounding_lines": (False, None, "set tauc to 0 at grounding-line cells below sea level (MISMIP+ style)"),
    "basal_yield_stress.mohr_coulomb.till_log_factor_transportable_water": (0.1, "m", "log-factor scale of the transportable-water contribution to N_till"),
    "basal_yield_stress.mohr_coulomb.tillphi_opt.dhdt_min": (1.0e-7, "m s-1", "[unimplemented] tillphi_opt: only adjust where |dh/dt| is below this (quasi-steady surface)"),

    # --- rheology extras ----------------------------------------------------------
    "flow_law.Hooke.A": (4.42e-9, "s-1 MPa-3", "Hooke (1981) softness prefactor"),
    "flow_law.Hooke.Q": (7.88e4, "J mol-1", "Hooke activation energy"),
    "flow_law.Hooke.C": (0.16612, "K3", "Hooke C constant"),
    "flow_law.Hooke.k": (1.17, None, "Hooke k constant"),
    "flow_law.Hooke.Tr": (273.39, "K", "Hooke Tr constant"),
    "flow_law.grain_aware_GK": (False, None, "use the grain-size-dependent Goldsby-Kohlstedt composite law"),

    # --- energy extras --------------------------------------------------------
    "energy.allow_temperature_above_melting": (False, None, "tolerate input temperatures above the pressure-melting point"),
    "energy.temperature_dependent_conductivity": (False, None, "k(T) instead of constant cold-ice conductivity"),
    "energy.enthalpy.cook_temperate_ice": (False, None, "[unimplemented] legacy: treat temperate ice enthalpy sources explicitly"),
    "energy.max_low_temperature_count": (10, None, "abort after this many too-cold-ice errors"),
    "energy.basal_melt.max": (1.0, "m year-1", "sanity cap on the basal melt rate"),
    "energy.bedrock_thermal.file": ("", None, "file with the initial bedrock temperature profile"),
    "energy.temperature_driven_basal_melt.enabled": (False, None, "[unimplemented] legacy cold-mode basal melt from the basal temperature excess"),

    # --- geometry extras --------------------------------------------------------
    "geometry.part_grid.max_iterations": (3, None, "residual-redistribution sweeps per transport step"),
    "geometry.front_retreat.prescribed.file": ("", None, "ISMIP6 land_ice_area_fraction_retreat forcing file"),
    "geometry.front_retreat.use_cfl": (False, None, "alias of calving.front_retreat.use_cfl"),
    "geometry.front_retreat.wrap_around": (False, None, "[unimplemented] allow retreat across periodic boundaries"),
    "geometry.ice_thickness.max": (1.0e4, "m", "sanity cap on the ice thickness"),

    # --- hydrology extras --------------------------------------------------------
    "hydrology.surface_input.file": ("", None, "file with water_input_rate added to the subglacial system"),
    "hydrology.surface_input_from_runoff": (False, None, "feed the surface-model runoff into the subglacial system"),
    "hydrology.add_water_input_to_till_storage": (True, None, "surface input fills the till before the transport layer"),
    "hydrology.routing.include_floating_ice": (False, None, "route water under ice shelves too"),
    "hydrology.tillwat_decay_rate_grounded_only": (True, None, "the till drainage C applies only under grounded ice"),
    "hydrology.nullstrip_width": (-1.0, "m", "[unimplemented] regional mode: no-hydrology strip width (< 0 = none)"),
    "hydrology.distributed.phi_0": (0.01, None, "distributed model englacial porosity (reference name; hydrology.regularizing_porosity is the short alias)"),

    # --- calving extras ------------------------------------------------------------
    "calving.eigen_calving.make_margin_floating": (False, None, "treat grounded margin cells as floating for eigencalving"),
    "calving.rate_scaling.file": ("", None, "scalar time series scaling all calving rates (-calving_rate_scaling_file)"),
    "calving.thickness_calving.file": ("", None, "file with a 2D calving_threshold field"),
    "calving.vonmises_calving.sigma_max_file": ("", None, "file with a 2D von Mises threshold field"),
    "calving.vonmises_calving.use_custom_flow_law": (False, None, "[unimplemented] use the SSA flow law instead of GPBLD for the von Mises stress"),
    "calving.hayhurst_calving.modifier": (1.0, None, "multiplier on the Hayhurst rate"),
    "calving.float_kill.calve_near_grounding_line": (True, None, "float_kill also removes floating cells adjacent to the grounding line"),
    "calving.float_kill.margin_only": (False, None, "float_kill only removes marginal floating cells"),

    # --- frontal melt extras ----------------------------------------------------
    "frontal_melt.given.file": ("", None, "file with frontal_melt_rate for -frontal_melt given"),
    "frontal_melt.routing.file": ("", None, "file with theta/salinity/depth inputs of the discharge-routing plume"),
    "frontal_melt.routing.parameter_a": (3e-4, None, "plume parameterization A in per-day form: melt [m/day] = (A h q_sg^alpha + B) theta^beta with q_sg in m/day (Xu et al. 2013 / Rignot et al. 2016)"),
    "frontal_melt.routing.parameter_b": (0.15, None, "plume parameterization B [m day-1 per degC^beta]"),
    "frontal_melt.routing.power_alpha": (0.39, None, "plume discharge exponent alpha"),
    "frontal_melt.routing.power_beta": (1.18, None, "plume thermal-forcing exponent beta"),

    # --- bed deformation extras ---------------------------------------------------

    # --- atmosphere extras -----------------------------------------------------
    "atmosphere.anomaly.file": ("", None, "file with air_temp_anomaly/precipitation_anomaly stacks"),
    "atmosphere.elevation_change.file": ("", None, "file with the reference surface elevation of the lapse modifier"),
    "atmosphere.one_station.file": ("", None, "scalar time-series file of the one_station atmosphere"),
    "atmosphere.searise_greenland.file": ("", None, "file overriding the SeaRISE parameterization inputs"),
    "atmosphere.yearly_cycle.file": ("", None, "file with air_temp_mean_annual/july + precip of the cosine cycle"),
    "atmosphere.yearly_cycle.scaling.file": ("", None, "scalar amplitude-scaling series of the cosine yearly cycle"),
    "atmosphere.fausto_air_temp.enabled": (False, None, "[n/a in this architecture: the parameterization is selected with -atmosphere searise_greenland; the coefficient family is live there] Fausto et al. (2009) Greenland near-surface lapse parameterization"),
    "atmosphere.fausto_air_temp.d_ma": (314.98, "K", "Fausto mean-annual intercept"),
    "atmosphere.fausto_air_temp.gamma_ma": (-6.309e-3, "K m-1", "Fausto mean-annual elevation gradient"),
    "atmosphere.fausto_air_temp.c_ma": (-0.7189, "K degree-1", "Fausto mean-annual latitude coefficient"),
    "atmosphere.fausto_air_temp.kappa_ma": (-0.0672, "K degree-1", "Fausto mean-annual longitude coefficient"),
    "atmosphere.fausto_air_temp.d_mj": (287.85, "K", "Fausto mean-July intercept"),
    "atmosphere.fausto_air_temp.gamma_mj": (-5.426e-3, "K m-1", "Fausto mean-July elevation gradient"),
    "atmosphere.fausto_air_temp.c_mj": (-0.1585, "K degree-1", "Fausto mean-July latitude coefficient"),
    "atmosphere.fausto_air_temp.kappa_mj": (0.0518, "K degree-1", "Fausto mean-July longitude coefficient"),
    "atmosphere.fausto_air_temp.summer_peak_day": (196, None, "day of year of the summer temperature peak"),

    # --- surface extras -----------------------------------------------------------
    "surface.anomaly.file": ("", None, "file with climatic_mass_balance_anomaly/ice_surface_temp_anomaly"),
    "surface.elevation_change.file": ("", None, "file with the reference usurf of the surface lapse modifier"),
    "surface.force_to_thickness.file": ("", None, "file with the target thickness of force_to_thickness"),
    "surface.force_to_thickness.ice_free_alpha_factor": (1.0, None, "alpha multiplier where the target is ice-free"),
    "surface.force_to_thickness.start_time": (-1.0e9, "years", "nudging starts at this model time"),
    "surface.ismip6.file": ("", None, "ISMIP6 SMB + temperature anomaly forcing file"),
    "surface.ismip6.reference_file": ("", None, "ISMIP6 reference climatology file"),
    "surface.initialization.file": ("", None, "[n/a in this architecture: the restart file carries the surface model's state] file with the stored effective surface fields (restart wrapper)"),
    "surface.pdd.interpret_precip_as_snow": (False, None, "treat all precipitation as snow regardless of air temperature"),
    "surface.pdd.firn_compaction_to_accumulation_ratio": (0.75, None, "fraction of surviving snow promoted to firn at the balance-year rollover"),
    "surface.pdd.max_evals_per_year": (52, None, "PDD sub-intervals per year"),
    "surface.pdd.fausto.enabled": (False, None, "Fausto et al. (2009) latitude-dependent PDD factors"),
    "surface.pdd.fausto.latitude_beta_w": (72.0, "degrees", "Fausto PDD factor transition latitude"),
    "surface.pdd.fausto.beta_ice_w": (0.007, "m K-1 day-1", "Fausto warm-regime ice melt factor"),
    "surface.pdd.fausto.beta_snow_w": (0.003, "m K-1 day-1", "Fausto warm-regime snow melt factor"),
    "surface.pdd.fausto.beta_ice_c": (0.015, "m K-1 day-1", "Fausto cold-regime ice melt factor"),
    "surface.pdd.fausto.beta_snow_c": (0.003, "m K-1 day-1", "Fausto cold-regime snow melt factor"),
    "surface.pdd.fausto.T_c": (272.15, "K", "Fausto cold-regime temperature bound"),
    "surface.pdd.fausto.T_w": (283.15, "K", "Fausto warm-regime temperature bound"),

    # --- ocean extras ----------------------------------------------------------
    "ocean.anomaly.file": ("", None, "file with shelf_base_mass_flux anomalies"),
    "ocean.delta_SL.file": ("", None, "scalar sea-level offset series (-ocean ...,delta_SL)"),
    "ocean.delta_sl_2d.file": ("", None, "2D sea-level offset stack for delta_sl_2d"),
    "ocean.runoff_to_ocean_melt_power_alpha": (0.54, None, "runoff_SMB melt power on runoff (Xu et al. 2013)"),
    "ocean.runoff_to_ocean_melt_power_beta": (1.17, None, "runoff_SMB melt power on the air-temperature anomaly"),
    "ocean.runoff_to_ocean_melt_factor": (1.0, None, "runoff_SMB melt prefactor B in melt *= 1 + B Q^alpha dT^beta"),
    "ocean.runoff_to_ocean_melt.temp_to_runoff_a": (0.1, "K-1", "fractional surface-runoff change per Kelvin of air-temperature anomaly (runoff_SMB Q = a dT)"),
    "ocean.pico.exclude_ice_rises": (True, None, "PICO: ice rises do not count as grounding-line boxes"),
    "ocean.pico.maximize_grounding_line_distance": (False, None, "PICO box assignment uses the max GL distance convention"),
    "ocean.pico.file": ("", None, "NetCDF file with theta_ocean / salinity_ocean (and optionally basins) for PICO (reference -ocean pico input file)"),
    "ocean.pico.periodic": (False, None, "treat the PICO forcing file as periodic in time"),
    "ocean.given.period": (0.0, "years", "period of the ocean given forcing (0 = not periodic)"),
    "frontal_melt.discharge_given.file": ("", None, "NetCDF file with theta_ocean and subglacial water flux for the discharge_given plume parameterization"),
    "frontal_melt.discharge_given.periodic": (False, None, "[unimplemented] treat the discharge_given forcing file as periodic in time"),
    "stress_balance.prescribed_sliding.file": ("", None, "NetCDF file with u_ssa/v_ssa (or ubar/vbar) for -stress_balance prescribed_sliding"),
    "stress_balance.prescribed_sliding.periodic": (False, None, "[unimplemented] treat the prescribed-sliding file as periodic in time"),
    "surface.given.smb_max": (9.1e3, "kg m-2 year-1", "error cap on the climatic mass balance read from surface.given.file (reference surface.given.smb_max: catches unit mistakes in input files)"),
    "surface.debm_simple.max_evals_per_year": (52, None, "dEBM-simple insolation/melt evaluations per year (the reference's pdd max_evals analog)"),
    "ocean.pico.basins_file": ("", None, "file with the drainage-basin index field (variable basins)"),
    "ocean.th.clip_salinity": (True, None, "GivenTH: clip the interface salinity into [0, S_ocean]"),
    "ocean.always_grounded": (False, None, "legacy: ignore the ocean entirely"),

    # --- sea level extras ---------------------------------------------------------
    "sea_level.constant.delta_SL": (0.0, "m", "offset of the constant sea-level model"),

    # --- bootstrapping defaults -----------------------------------------------------
    "bootstrapping.defaults.bed": (1.0, "m", "default bed elevation when topg is missing"),
    "bootstrapping.defaults.ice_thickness": (0.0, "m", "default thickness when thk is missing"),
    "bootstrapping.defaults.uplift": (0.0, "m s-1", "default bed uplift rate"),
    "bootstrapping.defaults.bmelt": (0.0, "m s-1", "default basal melt rate"),
    "bootstrapping.defaults.tillwat": (0.0, "m", "default till water thickness"),
    "bootstrapping.defaults.bwat": (0.0, "m", "default transportable water thickness"),
    "bootstrapping.defaults.fracture_density": (0.0, None, "default fracture density"),
    "bootstrapping.temperature_heuristic": ("smb", None, "smb | quartic_guess: bootstrap temperature profile heuristic"),

    # --- inverse problems (reference src/inverse/; the rebuild's adjoint
    #     toolkit reads these) ------------------------------------------------
    "inverse.design_variable": ("tauc", None, "tauc | hardav: inverted design variable"),
    "inverse.design.param": ("exp", None, "ident | square | exp: design-variable parameterization"),
    "inverse.design.cL2": (1.0, None, "L2 regularization weight of the design functional"),
    "inverse.design.cH1": (0.0, None, "H1 (gradient) regularization weight"),
    "inverse.design.cTV": (0.0, None, "total-variation regularization weight"),
    "inverse.design.tv_epsilon": (0.1, None, "TV functional smoothing parameter"),
    "inverse.ssa.tauc_min": (1.0e3, "Pa", "lower bound of the inverted yield stress"),
    "inverse.ssa.tauc_max": (5.0e6, "Pa", "upper bound of the inverted yield stress"),
    "inverse.ssa.hardav_min": (1.0e6, "Pa s0.333333", "lower bound of the inverted hardness"),
    "inverse.ssa.hardav_max": (1.0e9, "Pa s0.333333", "upper bound of the inverted hardness"),
    "inverse.ssa.velocity_misfit_weight": (1.0, None, "weight of the velocity misfit functional"),
    "inverse.ssa.length_scale": (50.0e3, "m", "length scale nondimensionalizing the regularizers"),
    "inverse.max_iterations": (100, None, "optimizer iteration cap"),
    "inverse.gradient_tolerance": (1.0e-6, None, "optimizer gradient-norm stop"),
    "inverse.step_tolerance": (1.0e-10, None, "optimizer step-size stop"),
    "inverse.state_file": ("", None, "write/read the inversion iterate for restarts"),
    "inverse.target_misfit": (100.0, "m year-1", "Morozov discrepancy target of the misfit"),
    "inverse.log_ratio": (10.0, None, "exp parameterization: bound of |log(d/d0)|"),

    # --- regional extras ----------------------------------------------------------
    "regional.no_model_strip": (5.0, "km", "width of the no-model strip (-no_model_strip)"),
    "regional.zero_gradient": (False, None, "zero-gradient thickness BC at the strip instead of stored values"),

    # --- fracture density extras -----------------------------------------------------
    "fracture_density.borstad_limit": (False, None, "damage jumps to the Borstad et al. (2016) constitutive-envelope equilibrium where the criterion is exceeded"),
    "fracture_density.constant_fd": (False, None, "freeze growth/healing: transport the fracture field only"),
    "fracture_density.constant_healing": (False, None, "heal at a constant rate instead of strain-dependent"),
    "fracture_density.fd2d_scheme": (True, None, "minmod-limited 2nd-order upwind fracture transport (off = donor cell)"),
    "fracture_density.fracture_weighted_healing": (False, None, "weight healing by (1 - phi)"),
    "fracture_density.include_grounded_ice": (False, None, "grow fractures on grounded ice too"),
    "fracture_density.initiation_stress_threshold": (7.0e4, "Pa", "stress threshold of the max_shear_stress / lefm criteria"),
    "fracture_density.lefm": (False, None, "tensile-stress (LEFM mode-I) initiation criterion"),
    "fracture_density.max_shear_stress": (False, None, "maximum-shear-stress initiation criterion instead of the effective strain rate"),
    "fracture_density.phi0": (0.0, None, "fracture density applied at inflow boundaries"),

    # --- PICO physics constants (reference src/coupler/ocean/Pico*.cc) --------
    "ocean.pico.T_dummy": (-1.5, "degC", "ambient temperature fallback where no basin data exists"),
    "ocean.pico.S_dummy": (34.7, "g kg-1", "ambient salinity fallback"),
    "ocean.pico.meltFactor": (2.0e-2, None, "legacy Beckmann-Goosse melt factor (PIK fallback)"),

    # --- constants extras -------------------------------------------------------
    "constants.sea_water.salinity": (35.0, "g kg-1", "reference sea water salinity"),
    "constants.ice.grain_size": (1.0, "mm", "reference ice grain size"),

    # --- run info ---------------------------------------------------------------
    "run_info.command": ("", None, "command line stored in output files"),
})

# ---------------------------------------------------------------------------
# Third tranche: time-dependent-forcing periodicity flags, the
# climate_forcing group, orographic-precipitation (LTOP) physical constants,
# and remaining per-component knobs (upstream ``src/pism_config.cdl``).
# ---------------------------------------------------------------------------

PARAMETERS.update({
    # every file-based forcing can be marked periodic (repeat its time axis)
    "atmosphere.given.periodic": (False, None, "repeat the -atmosphere given forcing periodically"),
    "atmosphere.anomaly.periodic": (False, None, "repeat the atmosphere anomaly forcing periodically"),
    "atmosphere.delta_T.periodic": (False, None, "repeat the delta_T offsets periodically"),
    "atmosphere.delta_P.file": ("", None, "file of scalar precipitation offsets (-atmosphere ...,delta_P)"),
    "atmosphere.delta_P.periodic": (False, None, "repeat the delta_P offsets periodically"),
    "atmosphere.frac_P.periodic": (False, None, "repeat the frac_P scaling periodically"),
    "atmosphere.precip_scaling.periodic": (False, None, "repeat the precip_scaling forcing periodically"),
    "atmosphere.elevation_change.periodic": (False, None, "[unimplemented] repeat the elevation_change reference forcing periodically"),
    "surface.given.periodic": (False, None, "repeat the -surface given forcing periodically"),
    "surface.anomaly.periodic": (False, None, "repeat the surface anomaly forcing periodically"),
    "surface.delta_T.periodic": (False, None, "repeat the surface delta_T offsets periodically"),
    "surface.elevation_change.periodic": (False, None, "[unimplemented] repeat the elevation_change reference forcing periodically"),
    "surface.pdd.std_dev.periodic": (False, None, "[unimplemented] repeat the air_temp_sd forcing periodically"),
    "ocean.given.periodic": (False, None, "repeat the -ocean given forcing periodically"),
    "ocean.th.periodic": (False, None, "repeat the -ocean th forcing periodically"),
    "ocean.anomaly.periodic": (False, None, "repeat the ocean anomaly forcing periodically"),
    "ocean.delta_T.periodic": (False, None, "repeat the ocean delta_T offsets periodically"),
    "ocean.delta_SL.periodic": (False, None, "repeat the delta_SL offsets periodically"),
    "ocean.delta_MBP.periodic": (False, None, "repeat the delta_MBP offsets periodically"),
    "ocean.frac_MBP.periodic": (False, None, "repeat the frac_MBP scaling periodically"),
    "ocean.frac_SMB.file": ("", None, "file of scalar sub-shelf mass-flux scaling factors (-ocean ...,frac_SMB)"),
    "ocean.frac_SMB.periodic": (False, None, "repeat the frac_SMB scaling periodically"),
    "frontal_melt.given.periodic": (False, None, "[unimplemented] repeat the frontal-melt forcing periodically"),
    "sea_level.delta_sl.periodic": (False, None, "repeat the sea-level offsets periodically"),
    "sea_level.delta_sl_2d.periodic": (False, None, "repeat the 2D sea-level forcing periodically"),

    # shared forcing-evaluation knobs (upstream group climate_forcing.*)
    "climate_forcing.buffer_size": (60, None, "number of forcing records kept in memory while streaming time-dependent inputs"),
    "climate_forcing.evaluations_per_year": (52, None, "temporal resolution of period-averaged forcing evaluations"),

    # orographic precipitation (LTOP; Smith & Barstad 2004) physical constants
    "atmosphere.orographic_precipitation.coriolis_latitude": (0.0, "degree_north", "latitude used for the Coriolis parameter in the LTOP transfer function"),
    "atmosphere.orographic_precipitation.moist_adiabatic_lapse_rate": (-6.5e-3, "K m-1", "moist adiabatic lapse rate Gamma_m"),
    "atmosphere.orographic_precipitation.lapse_rate": (-5.8e-3, "K m-1", "environmental lapse rate gamma"),
    "atmosphere.orographic_precipitation.reference_density": (7.4e-3, "kg m-3", "reference saturation water vapor density Cw"),
    "atmosphere.orographic_precipitation.scale_factor": (1.0, None, "multiplier applied to the computed precipitation"),
    "atmosphere.orographic_precipitation.truncate": (True, None, "clip negative precipitation rates to zero"),
    "atmosphere.orographic_precipitation.grid_size_factor": (2, None, "pad the FFT grid to factor*N+1 to damp periodic wrap-around"),

    # PDD air-temperature variability latitude ramp
    "surface.pdd.std_dev.lapse_lat_base": (72.0, "degree_north", "latitude above which air_temp_sd is ramped"),
    "surface.pdd.std_dev.lapse_lat_rate": (0.0, "K degree_north-1", "air_temp_sd increase per degree latitude above lapse_lat_base"),

    # calving / front retreat
    "calving.ocean_kill.file": ("", None, "file with the fixed calving mask (-calving ocean_kill)"),

    # geometry / mass transport
    "geometry.update.use_basal_melt_rate": (True, None, "include the basal melt rate in the mass-continuity source term"),

    # isochrone tracing (upstream group isochrones.*; aliases of age.isochrones.*)
    "isochrones.deposition_times": ("", None, "times at which new isochronal layers start (-isochrones ...)"),
    "isochrones.bootstrapping.n_layers": (10, None, "isochronal layers allocated when bootstrapping"),

    # steady-state hydrology (Bueler 2022 emulation)
    "hydrology.steady.flux_update_interval": (10.0, "years", "recompute the steady water flux every this often"),
    "hydrology.steady.volume_ratio": (0.1, None, "[unimplemented] fraction of the modeled water volume routed instantaneously"),

    # yield-stress forcing
    "basal_yield_stress.mohr_coulomb.delta.file": ("", None, "scalar time series scaling the effective-fraction-of-overburden delta (-tauc_delta)"),

    # prescribed bed-topography evolution
    "bed_deformation.bed_topography_delta_file": ("", None, "file with topg_delta read by -bed_def given"),

    # stress balance
    "stress_balance.ice_free_thickness_standard": (10.0, "m", "ice thinner than this is treated as ice-free in the stress balance"),

    # runtime viewer
    "output.runtime.viewer.size": (320, None, "[unimplemented] default pixel size of runtime viewer maps (-view)"),
})

PARAMETERS.update({
    "time_stepping.hit_extra_times": (True, None, "adjust dt so -extra_times are hit exactly"),
    "time_stepping.hit_save_times": (True, None, "adjust dt so -save_times are hit exactly"),
    "time_stepping.hit_ts_times": (True, None, "adjust dt so -ts_times are hit exactly"),
    "stress_balance.ssa.fd.brutal_sliding": (False, None, "scale SSA sliding speeds by brutal_sliding_scale (experimental speed-up)"),
    "stress_balance.ssa.fd.brutal_sliding_scale": (1.0, None, "factor applied to SSA sliding speeds when brutal_sliding is on"),
})

# ---------------------------------------------------------------------------
# Fourth tranche (round 4): the remaining reference-config tail plus the
# rebuild-native runtime knobs that were previously hard-coded. Entries
# marked rebuild-native in the doc string have no upstream CDL counterpart.
# ---------------------------------------------------------------------------

PARAMETERS.update({
    # --- energy ---------------------------------------------------------------
    "energy.enthalpy.cold_bulge_max": (6.0e4, "J kg-1", "maximum amount by which advection may cool a column below its surface enthalpy (reference enthSystem 'bulge limiter'): the column solve clamps E >= E_surface - this; 6e4 J/kg is ~30 K"),

    # --- SIA age coupling (reference EDC/EemianGreenland runs) ----------------
    "stress_balance.sia.enhancement_factor_interglacial": (1.0, None, "SIA enhancement factor applied to ice deposited during an interglacial (depositional age t - age in [time.eemian_start, time.eemian_end] or after time.holocene_start); active with stress_balance.sia.e_age_coupling, requires age.enabled"),
    "stress_balance.ssa.enhancement_factor_interglacial": (1.0, None, "[unimplemented] SSA enhancement factor for interglacial ice (registered for reference parity; the rebuild's SSA applies the scalar stress_balance.ssa.enhancement_factor only — the SSA vertically-averaged hardness has no per-layer age weighting)"),

    # --- Blatter --------------------------------------------------------------
    "stress_balance.blatter.Glen_exponent": (3.0, None, "Glen exponent n of the Blatter solver"),

    # --- SSA inner solver ------------------------------------------------------
    "stress_balance.ssa.fd.krylov_method": ("bicgstab", None, "inner Krylov method: bicgstab (default; the discrete operator is nonsymmetric at the CFBC/Dirichlet closure) | cg (conjugate gradients — cheaper per iteration, for symmetric interior/verification problems; the reference exposes the same choice via -ssafd_ksp_type)"),

    # --- hydrology -------------------------------------------------------------
    "hydrology.routing.cfl_factor": (0.5, None, "CFL fraction of the routing/distributed explicit subcycle (rebuild-native knob; the reference hard-codes 1/2 in Routing::max_timestep_W_cfl)"),

    # --- ocean ------------------------------------------------------------------
    "ocean.melange_back_pressure_fraction": (0.0, None, "constant melange back pressure applied at calving fronts, as a fraction of the ice-overburden minus ocean pressure difference (reference -melange_back_pressure_fraction); the frac_MBP/delta_MBP modifiers override this with time series"),

    # --- geometry source gating -------------------------------------------------
    "geometry.update.use_surface_mass_balance": (True, None, "apply the surface mass balance in the mass-continuity source term (off: dynamics-only thickness evolution)"),

    # --- output ------------------------------------------------------------------
    "output.variable_order": ("yxz", None, "[unimplemented] in-file dimension order of output variables (-o_order); the TPU-native writer stores the CF-standard (time, z, y, x) = yxz order natively"),
    "output.runtime.viewer.variables": ("", None, "comma list of diagnostics rendered by the runtime map viewer (-view)"),
    "output.timeseries.variables": ("ice_volume_glacierized,ice_area_glacierized,max_velocity", None, "default scalar diagnostics written to -ts_file (-ts_vars)"),
    "output.async": (True, None, "overlap device->host transfers and NetCDF writes with the device loop (writer thread; the reference's parallel-I/O role). False = synchronous writes"),

    # --- dEBM paleo -------------------------------------------------------------
    "surface.debm_simple.paleo.periodic": (False, None, "[unimplemented] repeat the dEBM paleo orbital time series periodically"),

    # --- inverse ----------------------------------------------------------------
    "inverse.method": ("lbfgs", None, "optimizer of the -inverse driver: lbfgs (bounded L-BFGS with the TAO-style convergence ladder, the reference blmvm role) | adam"),

    # --- runtime (rebuild-native) ----------------------------------------------
    "runtime.jit.cache_dir": ("", None, "persistent XLA compilation-cache directory (jax compilation cache); reuses compiled executables across processes — the ~40 s first-step compile of a 5 km hybrid drops to seconds on a warm cache"),
    "runtime.platform": ("", None, "force the JAX platform (cpu | tpu; the -platform flag). Empty = default backend"),
    "runtime.profile.directory": ("", None, "write a jax profiler trace of the run to this directory (-profile; reference -profile/-log_view role)"),
    "runtime.pallas.interpret": (False, None, "run all Pallas kernels in interpreter mode (debugging: same semantics on any backend, much slower)"),
})
