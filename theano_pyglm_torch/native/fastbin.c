/* fastbin — spike-event binning on the host, in one linear pass.
 *
 * Turns event-format spike data (times in seconds, neuron ids) into the
 * dense (T, N) count matrix that Population.prepare_data consumes. For long
 * recordings (hours of events) the numpy scatter-add is bound by allocation
 * and indexing; this is one pass over the events.
 *
 * The port's own copy of theano_pyglm_tpu/native/fastbin.c. Built at first
 * use by theano_pyglm_torch/utils/binning.py with the system C compiler into
 * theano_pyglm_torch/_build/ and loaded through ctypes (no Python API).
 * Host code: nothing here runs on the GPU.
 */

void bin_events(const double *times, const long long *neurons,
                long long n_events, double dt, long long T, long long N,
                float *out /* (T*N), zero-initialized by the caller */) {
    /* times * (1/dt), truncated: the numpy path computes the same
     * expression, so both put a boundary event in the same bin */
    const double inv_dt = 1.0 / dt;
    for (long long i = 0; i < n_events; ++i) {
        long long t = (long long)(times[i] * inv_dt);
        long long n = neurons[i];
        if (t >= 0 && t < T && n >= 0 && n < N) {
            out[t * N + n] += 1.0f;
        }
    }
}
