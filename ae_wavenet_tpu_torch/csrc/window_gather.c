/* Batch window gather for the packed-int16 dataset, on the host.
 *
 * Slices B windows out of the packed memmap into one contiguous batch: one
 * memcpy per row, no Python dispatch per row, and the GIL released for the
 * whole gather (ctypes drops it around the call), so the loader's producer
 * thread runs beside the training step.
 *
 * Build: cc -O3 -shared -fPIC -o libwindow_gather.so window_gather.c -lm
 * (ae_wavenet_tpu_torch.data.native builds it at first use and raises when
 * it cannot.)
 */

#include <stdint.h>
#include <string.h>

void gather_windows_i16(
    const int16_t *data,      /* packed samples */
    const int64_t *offsets,   /* [n] window start indices */
    int64_t n,                /* batch size */
    int64_t w,                /* window length */
    int16_t *out              /* [n * w] output */
) {
    for (int64_t i = 0; i < n; ++i) {
        memcpy(out + i * w, data + offsets[i], (size_t)w * sizeof(int16_t));
    }
}

/* mu-law encode int16 PCM to uint8 ids on the host (256 classes; the
 * training path encodes on the device). */
#include <math.h>
void mu_encode_i16(const int16_t *x, int64_t n, uint8_t *out) {
    const double mu = 255.0;
    const double log1p_mu = log1p(mu);
    for (int64_t i = 0; i < n; ++i) {
        double v = (double)x[i] / 32768.0;
        double s = v < 0 ? -1.0 : 1.0;
        /* division, not a reciprocal multiply: the numpy encoder's order */
        double y = s * (log1p(mu * fabs(v)) / log1p_mu);
        double q = (y + 1.0) * 0.5 * mu;
        /* round half to even, as np.rint and torch.round do */
        long r = (long)rint(q);
        if (r < 0) r = 0;
        if (r > 255) r = 255;
        out[i] = (uint8_t)r;
    }
}
